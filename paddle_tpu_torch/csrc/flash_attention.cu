// Flash attention for Hopper (sm_90a): the forward (K1) and the two
// backward kernels, dQ (K2) and dK/dV (K3).
//
// Replaces paddle_tpu/ops/pallas_kernels.py: _flash_kernel (driven by
// _flash_attention_pallas), _flash_bwd_dq_kernel and _flash_bwd_dkv_kernel
// (driven by _flash_attention_bwd_pallas). It computes what those kernels
// compute, with their constants and casts:
//   - scores s = q . k^T * scale in float32; a masked score is -1e30;
//   - masks: keys past Tk, causal aligned bottom-right (query i sees keys
//     up to i + Tk - Tq), segment ids equal (packed batches);
//   - forward: online softmax over key tiles, p = exp(s - m) zeroed where
//     s <= -1e30 / 2, P cast to v's type before P . V, o = acc / max(l,
//     1e-30), lse = m + log(max(l, 1e-30)); a row with no visible key
//     gives o = 0;
//   - backward: P recomputed as exp(s - lse) where valid, else 0;
//     dS = P * (dP - delta) * scale with delta = sum(dO * O) given by the
//     caller; P cast to dO's type before dV = P^T dO, dS cast to k's (q's)
//     type before dQ = dS K (dK = dS^T Q);
//   - every sum in float32.
// It does not copy their TPU tiling: nothing is padded to 128 (tiles are
// bounds-guarded), lse is [B*H, Tq] float32 instead of broadcast over 128
// lanes, segment ids are read as [B, T] int32, and the sequential grid
// dimension of the TPU kernels is a loop inside one block.
//
// Bound: memory, at the Transformer LM's shape (16 x 8 heads, T 512, head
// dim 64, bf16, causal): K1 reads q, k, v and writes o and lse, ~34 MB,
// against ~4.3 GFLOP of causal products (~127 flop/byte, under the card's
// ~295 bf16 balance point), so ~10 us; K2 ~43 MB / 6.4 GFLOP, K3 ~51 MB /
// 8.6 GFLOP. What the design keeps from the TPU kernels: the [T, T] score
// matrix never reaches device memory in either direction (one 64 x 64 tile
// at a time in shared memory); dead tiles are skipped (the causal bound,
// and the segment-id range test: disjoint id ranges cannot match), so a
// causal run does about half the work; each block loads its Q (or K/V)
// tile once and streams the other side through shared memory. Simple
// first: no TMA, no wgmma, no pipelining of the tile loads.
//
// The products run as float32 FMAs on the CUDA cores in both types: in
// float32 (the reference mode) that keeps float32 exact where the tensor
// cores would round to tf32, and in bfloat16 it keeps every score and
// gradient sum an IEEE float32 sum, as the plain version's are, so P and
// dS round to the same bfloat16 values in both (tensor-core sums differ in
// the last bits and flip some of those roundings). 256 threads as 16 x 16:
// thread (ty, tx) owns tile rows 4*ty .. 4*ty+3 and columns tx + 16*j, so
// a row's reductions stay in a half-warp and its running max and sum in
// registers; tiles are float32 in shared memory with a padded row stride.
// Grid: K1 and K2 one block per (q tile, batch*head), K3 one per (k tile,
// batch*head).
//
// Layouts (the wrapper makes them so): q, o, dO, dq [B*H, Tq, D], k, v,
// dk, dv [B*H, Tk, D], all contiguous and of one type (float32 or
// bfloat16); lse, delta [B*H, Tq] float32; segment ids [B, Tq] and
// [B, Tk] int32 or null. D is 32, 64 or 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPS = kBK + 1;     // row stride of the [kBQ][kBK] P / dS tiles
constexpr float kNegInf = -1e30f;

template <typename T>
__device__ __forceinline__ float to_f32(T x);
template <>
__device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x cast to T and back: the cast the TPU kernels apply to P and dS before
// their second products.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32<T>(from_f32<T>(x));
}

// Reductions over the 16 lanes of a half-warp (the 16 threads of one ty).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse_in;
  const float* delta;
  const int* qseg;
  const int* kvseg;
  void* out;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  int H, Tq, Tk, causal;
  float scale;
};

// Rows [row0, row0 + n) of a row-major [total, D] matrix into a float tile
// with row stride ld; rows past `total` read as 0. The rows are contiguous
// in memory, so consecutive threads read consecutive elements.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          int row0, int total, int n) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int g = row0 + r;
    dst[r * ld + c] = g < total ? to_f32(src[(long long)g * D + c]) : 0.f;
  }
}

__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int row0, int total, int n) {
  for (int r = threadIdx.x; r < n; r += kThreads)
    dst[r] = row0 + r < total ? src[row0 + r] : 0.f;
}

__device__ __forceinline__ void load_ids(int* dst, const int* src, int row0,
                                         int total, int n) {
  for (int r = threadIdx.x; r < n; r += kThreads)
    dst[r] = row0 + r < total ? src[row0 + r] : 0;
}

// Least and greatest of the first n ids; every thread gets the same (a
// block-uniform skip decision).
__device__ __forceinline__ void id_range(const int* ids, int n, int& lo,
                                         int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = 0; i < n; ++i) {
    lo = min(lo, ids[i]);
    hi = max(hi, ids[i]);
  }
}

// Key tiles a block of query rows [q0, q0 + nqr) visits: all of them, or
// under causal masking those up to the last key its last row can see.
__device__ __forceinline__ int key_tiles(const Args& a, int q0, int nqr) {
  int n = (a.Tk + kBK - 1) / kBK;
  if (a.causal) {
    const int last_key = q0 + nqr - 1 + (a.Tk - a.Tq);
    n = last_key < 0 ? 0 : min(n, last_key / kBK + 1);
  }
  return n;
}

// ---------------------------------------------------------------------------
// K1: forward. One block per (q tile, batch*head).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(Args a) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;       // [kBK][LD]
  float* Vs = Ks + kBK * LD;       // [kBK][D]
  float* Ps = Vs + kBK * D;        // [kBQ][kPS]
  int* qid = reinterpret_cast<int*>(Ps + kBQ * kPS);  // [kBQ]
  int* kid = qid + kBQ;                               // [kBK]

  const int Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int qb = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y, b = bh / a.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qb * kBQ, nqr = min(kBQ, Tq - q0);
  const T* q = static_cast<const T*>(a.q) + (long long)bh * Tq * D;
  const T* k = static_cast<const T*>(a.k) + (long long)bh * Tk * D;
  const T* v = static_cast<const T*>(a.v) + (long long)bh * Tk * D;
  const bool seg = a.qseg != nullptr;

  load_tile<T, D>(Qs, LD, q, q0, Tq, kBQ);
  if (seg) load_ids(qid, a.qseg + (long long)b * Tq, q0, Tq, kBQ);
  __syncthreads();
  int qlo = 0, qhi = 0;
  int myq[4] = {0, 0, 0, 0};
  if (seg) {
    id_range(qid, nqr, qlo, qhi);
#pragma unroll
    for (int i = 0; i < 4; ++i) myq[i] = qid[ty * 4 + i];
  }

  float m[4], l[4], acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[i][c] = 0.f;
  }

  const int n_kt = key_tiles(a, q0, nqr);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK, nkr = min(kBK, Tk - k0);
    __syncthreads();   // the previous tile's readers are done
    if (seg) {
      load_ids(kid, a.kvseg + (long long)b * Tk, k0, Tk, kBK);
      __syncthreads();
      int klo, khi;
      id_range(kid, nkr, klo, khi);
      if (qhi < klo || qlo > khi) continue;   // no id can match: dead tile
    }
    load_tile<T, D>(Ks, LD, k, k0, Tk, kBK);
    load_tile<T, D>(Vs, D, v, k0, Tk, kBK);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kc[j] = Ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = kp < Tk;
        if (seg) ok = ok && myq[i] == kid[tx + 16 * j];
        if (a.causal) ok = ok && qp + off >= kp;
        s[i][j] = ok ? s[i][j] * a.scale : kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      const float mn = fmaxf(m[i], half_warp_max(mc));
      const float alpha = expf(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float e = expf(s[i][j] - mn);
        // a row with nothing visible so far has m == s == -1e30: its dead
        // entries must not count as exp(0) = 1
        e = s[i][j] > kNegInf * 0.5f ? e : 0.f;
        rs += e;
        Ps[(ty * 4 + i) * kPS + tx + 16 * j] = round_to<T>(e);
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < NJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < NJ; ++c) vv[c] = Vs[kk * D + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NJ; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* out = static_cast<T*>(a.out) + (long long)bh * Tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NJ; ++c)
      out[(long long)qp * D + tx + 16 * c] = from_f32<T>(acc[i][c] / den);
    if (a.lse_out != nullptr && tx == 0)
      a.lse_out[(long long)bh * Tq + qp] = m[i] + logf(den);
  }
}

// ---------------------------------------------------------------------------
// K2: dQ. One block per (q tile, batch*head); key tiles stream through.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Qs = smem;                // [kBQ][LD]
  float* Gs = Qs + kBQ * LD;       // dO [kBQ][LD]
  float* Ks = Gs + kBQ * LD;       // [kBK][LD]
  float* Vs = Ks + kBK * LD;       // [kBK][LD]
  float* Ss = Vs + kBK * LD;       // dS [kBQ][kPS]
  float* lse_s = Ss + kBQ * kPS;   // [kBQ]
  float* dl_s = lse_s + kBQ;       // [kBQ]
  int* qid = reinterpret_cast<int*>(dl_s + kBQ);   // [kBQ]
  int* kid = qid + kBQ;                            // [kBK]

  const int Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qb * kBQ, nqr = min(kBQ, Tq - q0);
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  const T* k = static_cast<const T*>(a.k) + koff;
  const T* v = static_cast<const T*>(a.v) + koff;
  const bool seg = a.qseg != nullptr;

  load_tile<T, D>(Qs, LD, static_cast<const T*>(a.q) + qoff, q0, Tq, kBQ);
  load_tile<T, D>(Gs, LD, static_cast<const T*>(a.dout) + qoff, q0, Tq, kBQ);
  load_rows(lse_s, a.lse_in + (long long)bh * Tq, q0, Tq, kBQ);
  load_rows(dl_s, a.delta + (long long)bh * Tq, q0, Tq, kBQ);
  if (seg) load_ids(qid, a.qseg + (long long)b * Tq, q0, Tq, kBQ);
  __syncthreads();
  int qlo = 0, qhi = 0;
  int myq[4] = {0, 0, 0, 0};
  float lse[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    lse[i] = lse_s[ty * 4 + i];
    dl[i] = dl_s[ty * 4 + i];
  }
  if (seg) {
    id_range(qid, nqr, qlo, qhi);
#pragma unroll
    for (int i = 0; i < 4; ++i) myq[i] = qid[ty * 4 + i];
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NJ; ++c) acc[i][c] = 0.f;

  const int n_kt = key_tiles(a, q0, nqr);
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK, nkr = min(kBK, Tk - k0);
    __syncthreads();
    if (seg) {
      load_ids(kid, a.kvseg + (long long)b * Tk, k0, Tk, kBK);
      __syncthreads();
      int klo, khi;
      id_range(kid, nkr, klo, khi);
      if (qhi < klo || qlo > khi) continue;
    }
    load_tile<T, D>(Ks, LD, k, k0, Tk, kBK);
    load_tile<T, D>(Vs, LD, v, k0, Tk, kBK);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ga[4], kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty * 4 + i) * LD + d];
        ga[i] = Gs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = Ks[(tx + 16 * j) * LD + d];
        vc[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vc[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = qp < Tq && kp < Tk;
        if (seg) ok = ok && myq[i] == kid[tx + 16 * j];
        if (a.causal) ok = ok && qp + off >= kp;
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        Ss[(ty * 4 + i) * kPS + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - dl[i]) * a.scale);
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float sv[4], kv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty * 4 + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < NJ; ++c) kv[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NJ; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

  T* dq = static_cast<T*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Tq) continue;
#pragma unroll
    for (int c = 0; c < NJ; ++c)
      dq[(long long)qp * D + tx + 16 * c] = from_f32<T>(acc[i][c]);
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV. One block per (k tile, batch*head); query tiles stream
// through.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  extern __shared__ float smem[];
  float* Ks = smem;                // [kBK][LD]
  float* Vs = Ks + kBK * LD;       // [kBK][LD]
  float* Qs = Vs + kBK * LD;       // [kBQ][LD]
  float* Gs = Qs + kBQ * LD;       // dO [kBQ][LD]
  float* Ps = Gs + kBQ * LD;       // P [kBQ][kPS]
  float* Ss = Ps + kBQ * kPS;      // dS [kBQ][kPS]
  float* lse_s = Ss + kBQ * kPS;   // [kBQ]
  float* dl_s = lse_s + kBQ;       // [kBQ]
  int* qid = reinterpret_cast<int*>(dl_s + kBQ);   // [kBQ]
  int* kid = qid + kBQ;                            // [kBK]

  const int Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int kt = blockIdx.x;       // causal: low key tiles see the most rows
  const int bh = blockIdx.y, b = bh / a.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kBK, nkr = min(kBK, Tk - k0);
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  const T* q = static_cast<const T*>(a.q) + qoff;
  const T* g = static_cast<const T*>(a.dout) + qoff;
  const bool seg = a.qseg != nullptr;

  load_tile<T, D>(Ks, LD, static_cast<const T*>(a.k) + koff, k0, Tk, kBK);
  load_tile<T, D>(Vs, LD, static_cast<const T*>(a.v) + koff, k0, Tk, kBK);
  if (seg) load_ids(kid, a.kvseg + (long long)b * Tk, k0, Tk, kBK);
  __syncthreads();
  int klo = 0, khi = 0;
  int myk[4] = {0, 0, 0, 0};
  if (seg) {
    id_range(kid, nkr, klo, khi);
#pragma unroll
    for (int j = 0; j < 4; ++j) myk[j] = kid[tx + 16 * j];
  }

  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NJ; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (Tq + kBQ - 1) / kBQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * kBQ, nqr = min(kBQ, Tq - q0);
    // causal: the tile's last row must see this tile's first key
    if (a.causal && q0 + nqr - 1 + off < k0) continue;
    __syncthreads();
    if (seg) {
      load_ids(qid, a.qseg + (long long)b * Tq, q0, Tq, kBQ);
      __syncthreads();
      int qlo, qhi;
      id_range(qid, nqr, qlo, qhi);
      if (qhi < klo || qlo > khi) continue;
    }
    load_tile<T, D>(Qs, LD, q, q0, Tq, kBQ);
    load_tile<T, D>(Gs, LD, g, q0, Tq, kBQ);
    load_rows(lse_s, a.lse_in + (long long)bh * Tq, q0, Tq, kBQ);
    load_rows(dl_s, a.delta + (long long)bh * Tq, q0, Tq, kBQ);
    __syncthreads();

    // rows: queries ty*4+i; columns: keys tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], ga[4], kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = Qs[(ty * 4 + i) * LD + d];
        ga[i] = Gs[(ty * 4 + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = Ks[(tx + 16 * j) * LD + d];
        vc[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vc[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, qp = q0 + r;
      const int qs = seg ? qid[r] : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = qp < Tq && kp < Tk;
        if (seg) ok = ok && qs == myk[j];
        if (a.causal) ok = ok && qp + off >= kp;
        const float p = ok ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
        Ps[r * kPS + tx + 16 * j] = round_to<T>(p);
        Ss[r * kPS + tx + 16 * j] =
            round_to<T>(p * (dp[i][j] - dl_s[r]) * a.scale);
      }
    }
    __syncthreads();

    // dV[kr] += sum_q P[q][kr] dO[q], dK[kr] += sum_q dS[q][kr] Q[q]
#pragma unroll 4
    for (int qq = 0; qq < kBQ; ++qq) {
      float pv[4], sv[4], gv[NJ], qv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[qq * kPS + ty * 4 + i];
        sv[i] = Ss[qq * kPS + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < NJ; ++c) {
        gv[c] = Gs[qq * LD + tx + 16 * c];
        qv[c] = Qs[qq * LD + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < NJ; ++c) {
          dv[i][c] = fmaf(pv[i], gv[c], dv[i][c]);
          dk[i][c] = fmaf(sv[i], qv[c], dk[i][c]);
        }
    }
  }

  T* dko = static_cast<T*>(a.dk) + koff;
  T* dvo = static_cast<T*>(a.dv) + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= Tk) continue;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      dko[(long long)kp * D + tx + 16 * c] = from_f32<T>(dk[i][c]);
      dvo[(long long)kp * D + tx + 16 * c] = from_f32<T>(dv[i][c]);
    }
  }
}

// Dynamic shared memory of each kernel, in bytes.
template <int D>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((size_t)(kBQ + kBK) * (D + 1) + (size_t)kBK * D +
                          (size_t)kBQ * kPS) +
         sizeof(int) * (kBQ + kBK);
}
template <int D>
constexpr size_t dq_smem() {
  return sizeof(float) * (2 * (size_t)(kBQ + kBK) * (D + 1) +
                          (size_t)kBQ * kPS + 2 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}
template <int D>
constexpr size_t dkv_smem() {
  return sizeof(float) * (2 * (size_t)(kBQ + kBK) * (D + 1) +
                          2 * (size_t)kBQ * kPS + 2 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}

template <typename Kernel>
cudaError_t launch(Kernel kern, dim3 grid, size_t smem, cudaStream_t s,
                   const Args& a) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, kThreads, smem, s>>>(a);
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
cudaError_t run(int which, const Args& a, int BH, cudaStream_t s) {
  const int nq = (a.Tq + kBQ - 1) / kBQ, nk = (a.Tk + kBK - 1) / kBK;
  switch (which) {
    case kFwd:
      return launch(flash_fwd_kernel<T, D>, dim3(nq, BH), fwd_smem<D>(), s, a);
    case kDq:
      return launch(flash_dq_kernel<T, D>, dim3(nq, BH), dq_smem<D>(), s, a);
    default:
      return launch(flash_dkv_kernel<T, D>, dim3(nk, BH), dkv_smem<D>(), s,
                    a);
  }
}

template <typename T>
cudaError_t run_d(int which, int D, const Args& a, int BH, cudaStream_t s) {
  switch (D) {
    case 32:
      return run<T, 32>(which, a, BH, s);
    case 64:
      return run<T, 64>(which, a, BH, s);
    case 128:
      return run<T, 128>(which, a, BH, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int run_checked(int which, int is_bf16, int D, const Args& a, int BH,
                void* stream) {
  if (BH < 1 || BH > 65535 || a.H < 1 || BH % a.H != 0 || a.Tq < 1 ||
      a.Tk < 1)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = is_bf16 ? run_d<__nv_bfloat16>(which, D, a, BH, s)
                                : run_d<float>(which, D, a, BH, s);
  return static_cast<int>(e);
}

}  // namespace

extern "C" {

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Each entry point launches on `stream`, does not synchronize, and returns
// the launch's cudaError_t (0 on success). is_bf16: 1 for bfloat16 tensors,
// 0 for float32. qseg / kvseg null: no segment masking. lse null (forward):
// no lse output.
int ptt_flash_fwd(int is_bf16, int D, const void* q, const void* k,
                  const void* v, const int* qseg, const int* kvseg, void* out,
                  float* lse, int BH, int H, int Tq, int Tk, float scale,
                  int causal, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.qseg = qseg;
  a.kvseg = kvseg;
  a.out = out;
  a.lse_out = lse;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.causal = causal;
  a.scale = scale;
  return run_checked(kFwd, is_bf16, D, a, BH, stream);
}

int ptt_flash_bwd_dq(int is_bf16, int D, const void* q, const void* k,
                     const void* v, const void* dout, const float* lse,
                     const float* delta, const int* qseg, const int* kvseg,
                     void* dq, int BH, int H, int Tq, int Tk, float scale,
                     int causal, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.qseg = qseg;
  a.kvseg = kvseg;
  a.dq = dq;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.causal = causal;
  a.scale = scale;
  return run_checked(kDq, is_bf16, D, a, BH, stream);
}

int ptt_flash_bwd_dkv(int is_bf16, int D, const void* q, const void* k,
                      const void* v, const void* dout, const float* lse,
                      const float* delta, const int* qseg, const int* kvseg,
                      void* dk, void* dv, int BH, int H, int Tq, int Tk,
                      float scale, int causal, void* stream) {
  Args a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.dout = dout;
  a.lse_in = lse;
  a.delta = delta;
  a.qseg = qseg;
  a.kvseg = kvseg;
  a.dk = dk;
  a.dv = dv;
  a.H = H;
  a.Tq = Tq;
  a.Tk = Tk;
  a.causal = causal;
  a.scale = scale;
  return run_checked(kDkv, is_bf16, D, a, BH, stream);
}

}  // extern "C"
