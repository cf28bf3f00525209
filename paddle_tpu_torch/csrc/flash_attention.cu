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
// at a time); dead tiles are skipped (the causal bound, and the segment-id
// range test: disjoint id ranges cannot match), so a causal run does about
// half the work; each block loads its Q (or K/V) tile once and streams the
// other side through shared memory.
//
// Two designs. bfloat16 K1-K3 run on the tensor cores (mma.sync, with
// cp.async pipelines; see "K1-K3 for bfloat16" below). float32, the
// reference mode, runs the products as float32 FMAs on the CUDA cores,
// which keeps float32 exact where the tensor cores would round to tf32:
// 256 threads as 16 x 16, thread (ty, tx) owns tile rows
// 4*ty .. 4*ty+3 and columns tx + 16*j, so a row's reductions stay in a
// half-warp and its running max and sum in registers; tiles are float32 in
// shared memory with a padded row stride, loaded synchronously. Grid: K1
// and K2 one block per (q tile, batch*head), K3 one per (k tile,
// batch*head).
//
// Layouts (the wrapper makes them so): q, o, dO, dq [B*H, Tq, D], k, v,
// dk, dv [B*H, Tk, D], all contiguous and of one type (float32 or
// bfloat16); lse, delta [B*H, Tq] float32; segment ids [B, Tq] and
// [B, Tk] int32 or null. D is 32, 64, 128 or 256, or a multiple of 128
// above 256 (the wide-head route, below: bfloat16 K1 and K2 on the tensor
// cores in thread-block clusters, the rest on the CUDA cores); the
// wrapper zero-pads any other D to the next of those.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kBQ = 64;          // query rows per tile
constexpr int kBK = 64;          // key rows per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPS = kBK + 1;     // row stride of the [kBQ][kBK] P / dS tiles
constexpr float kNegInf = -1e30f;

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
  int D, H, Tq, Tk, causal;
  float scale;
};

// Rows [row0, row0 + n) of a row-major [total, D] matrix into a float tile
// with row stride ld; rows past `total` read as 0. The rows are contiguous
// in memory, so consecutive threads read consecutive elements.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          int row0, int total, int n) {
  for (int e = threadIdx.x; e < n * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const int g = row0 + r;
    dst[r * ld + c] = g < total ? src[(long long)g * D + c] : 0.f;
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
template <int D>
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
  const float* q = static_cast<const float*>(a.q) + (long long)bh * Tq * D;
  const float* k = static_cast<const float*>(a.k) + (long long)bh * Tk * D;
  const float* v = static_cast<const float*>(a.v) + (long long)bh * Tk * D;
  const bool seg = a.qseg != nullptr;

  load_tile<D>(Qs, LD, q, q0, Tq, kBQ);
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
    load_tile<D>(Ks, LD, k, k0, Tk, kBK);
    load_tile<D>(Vs, D, v, k0, Tk, kBK);
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
        Ps[(ty * 4 + i) * kPS + tx + 16 * j] = e;
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

  float* out = static_cast<float*>(a.out) + (long long)bh * Tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < NJ; ++c)
      out[(long long)qp * D + tx + 16 * c] = acc[i][c] / den;
    if (a.lse_out != nullptr && tx == 0)
      a.lse_out[(long long)bh * Tq + qp] = m[i] + logf(den);
  }
}

// ---------------------------------------------------------------------------
// K2: dQ (float32; bfloat16 takes flash_dq_tc_kernel below). One block per
// (q tile, batch*head); key tiles stream through. The q tile is f32_bq
// rows: 64, or 32 at D = 256, where 64 rows of Q, dO, K and V exceed the
// shared memory a block may have; thread (ty, tx) owns rows RQ*ty ..
// RQ*ty + RQ-1.
// ---------------------------------------------------------------------------
template <int D>
__host__ __device__ constexpr int f32_bq() {
  return D <= 128 ? kBQ : 32;
}

template <int D>
__global__ void __launch_bounds__(kThreads) flash_dq_kernel(Args a) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  constexpr int BQ = f32_bq<D>();
  constexpr int RQ = BQ / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][LD]
  float* Gs = Qs + BQ * LD;        // dO [BQ][LD]
  float* Ks = Gs + BQ * LD;        // [kBK][LD]
  float* Vs = Ks + kBK * LD;       // [kBK][LD]
  float* Ss = Vs + kBK * LD;       // dS [BQ][kPS]
  float* lse_s = Ss + BQ * kPS;    // [BQ]
  float* dl_s = lse_s + BQ;        // [BQ]
  int* qid = reinterpret_cast<int*>(dl_s + BQ);    // [BQ]
  int* kid = qid + BQ;                             // [kBK]

  const int Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qb * BQ, nqr = min(BQ, Tq - q0);
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  const float* k = static_cast<const float*>(a.k) + koff;
  const float* v = static_cast<const float*>(a.v) + koff;
  const bool seg = a.qseg != nullptr;

  load_tile<D>(Qs, LD, static_cast<const float*>(a.q) + qoff, q0, Tq, BQ);
  load_tile<D>(Gs, LD, static_cast<const float*>(a.dout) + qoff, q0, Tq, BQ);
  load_rows(lse_s, a.lse_in + (long long)bh * Tq, q0, Tq, BQ);
  load_rows(dl_s, a.delta + (long long)bh * Tq, q0, Tq, BQ);
  if (seg) load_ids(qid, a.qseg + (long long)b * Tq, q0, Tq, BQ);
  __syncthreads();
  int qlo = 0, qhi = 0;
  int myq[RQ] = {};
  float lse[RQ], dl[RQ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    lse[i] = lse_s[ty * RQ + i];
    dl[i] = dl_s[ty * RQ + i];
  }
  if (seg) {
    id_range(qid, nqr, qlo, qhi);
#pragma unroll
    for (int i = 0; i < RQ; ++i) myq[i] = qid[ty * RQ + i];
  }

  float acc[RQ][NJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i)
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
    load_tile<D>(Ks, LD, k, k0, Tk, kBK);
    load_tile<D>(Vs, LD, v, k0, Tk, kBK);
    __syncthreads();

    float s[RQ][4], dp[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RQ], ga[RQ], kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qa[i] = Qs[(ty * RQ + i) * LD + d];
        ga[i] = Gs[(ty * RQ + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = Ks[(tx + 16 * j) * LD + d];
        vc[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vc[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int qp = q0 + ty * RQ + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = qp < Tq && kp < Tk;
        if (seg) ok = ok && myq[i] == kid[tx + 16 * j];
        if (a.causal) ok = ok && qp + off >= kp;
        const float p = ok ? expf(s[i][j] * a.scale - lse[i]) : 0.f;
        Ss[(ty * RQ + i) * kPS + tx + 16 * j] =
            p * (dp[i][j] - dl[i]) * a.scale;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float sv[RQ], kv[NJ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) sv[i] = Ss[(ty * RQ + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < NJ; ++c) kv[c] = Ks[kk * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int c = 0; c < NJ; ++c) acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

  float* dq = static_cast<float*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int qp = q0 + ty * RQ + i;
    if (qp >= Tq) continue;
#pragma unroll
    for (int c = 0; c < NJ; ++c)
      dq[(long long)qp * D + tx + 16 * c] = acc[i][c];
  }
}

// ---------------------------------------------------------------------------
// K3: dK and dV. One block per (k tile, batch*head); query tiles of f32_bq
// rows stream through (32 at D = 256, as K2).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(kThreads) flash_dkv_kernel(Args a) {
  constexpr int NJ = D / 16;
  constexpr int LD = D + 1;
  constexpr int BQ = f32_bq<D>();
  constexpr int RQ = BQ / 16;
  extern __shared__ float smem[];
  float* Ks = smem;                // [kBK][LD]
  float* Vs = Ks + kBK * LD;       // [kBK][LD]
  float* Qs = Vs + kBK * LD;       // [BQ][LD]
  float* Gs = Qs + BQ * LD;        // dO [BQ][LD]
  float* Ps = Gs + BQ * LD;        // P [BQ][kPS]
  float* Ss = Ps + BQ * kPS;       // dS [BQ][kPS]
  float* lse_s = Ss + BQ * kPS;    // [BQ]
  float* dl_s = lse_s + BQ;        // [BQ]
  int* qid = reinterpret_cast<int*>(dl_s + BQ);    // [BQ]
  int* kid = qid + BQ;                             // [kBK]

  const int Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int kt = blockIdx.x;       // causal: low key tiles see the most rows
  const int bh = blockIdx.y, b = bh / a.H;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kBK, nkr = min(kBK, Tk - k0);
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  const float* q = static_cast<const float*>(a.q) + qoff;
  const float* g = static_cast<const float*>(a.dout) + qoff;
  const bool seg = a.qseg != nullptr;

  load_tile<D>(Ks, LD, static_cast<const float*>(a.k) + koff, k0, Tk, kBK);
  load_tile<D>(Vs, LD, static_cast<const float*>(a.v) + koff, k0, Tk, kBK);
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

  const int n_qt = (Tq + BQ - 1) / BQ;
  for (int qt = 0; qt < n_qt; ++qt) {
    const int q0 = qt * BQ, nqr = min(BQ, Tq - q0);
    // causal: the tile's last row must see this tile's first key
    if (a.causal && q0 + nqr - 1 + off < k0) continue;
    __syncthreads();
    if (seg) {
      load_ids(qid, a.qseg + (long long)b * Tq, q0, Tq, BQ);
      __syncthreads();
      int qlo, qhi;
      id_range(qid, nqr, qlo, qhi);
      if (qhi < klo || qlo > khi) continue;
    }
    load_tile<D>(Qs, LD, q, q0, Tq, BQ);
    load_tile<D>(Gs, LD, g, q0, Tq, BQ);
    load_rows(lse_s, a.lse_in + (long long)bh * Tq, q0, Tq, BQ);
    load_rows(dl_s, a.delta + (long long)bh * Tq, q0, Tq, BQ);
    __syncthreads();

    // rows: queries ty*RQ+i; columns: keys tx+16j
    float s[RQ][4], dp[RQ][4];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[RQ], ga[RQ], kc[4], vc[4];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qa[i] = Qs[(ty * RQ + i) * LD + d];
        ga[i] = Gs[(ty * RQ + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kc[j] = Ks[(tx + 16 * j) * LD + d];
        vc[j] = Vs[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
          dp[i][j] = fmaf(ga[i], vc[j], dp[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i, qp = q0 + r;
      const int qs = seg ? qid[r] : 0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + tx + 16 * j;
        bool ok = qp < Tq && kp < Tk;
        if (seg) ok = ok && qs == myk[j];
        if (a.causal) ok = ok && qp + off >= kp;
        const float p = ok ? expf(s[i][j] * a.scale - lse_s[r]) : 0.f;
        Ps[r * kPS + tx + 16 * j] = p;
        Ss[r * kPS + tx + 16 * j] =
            p * (dp[i][j] - dl_s[r]) * a.scale;
      }
    }
    __syncthreads();

    // dV[kr] += sum_q P[q][kr] dO[q], dK[kr] += sum_q dS[q][kr] Q[q]
#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
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

  float* dko = static_cast<float*>(a.dk) + koff;
  float* dvo = static_cast<float*>(a.dv) + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + ty * 4 + i;
    if (kp >= Tk) continue;
#pragma unroll
    for (int c = 0; c < NJ; ++c) {
      dko[(long long)kp * D + tx + 16 * c] = dk[i][c];
      dvo[(long long)kp * D + tx + 16 * c] = dv[i][c];
    }
  }
}

// ---------------------------------------------------------------------------
// K1-K3 for bfloat16 on the tensor cores.
//
// The float32 kernels above keep every product exact in float32 (the
// reference mode); bfloat16 inputs take these instead. Every product is an
// mma.sync.m16n8k16 (bf16 operands, float32 sums). Each warp owns 16 rows
// of its side (queries in K1 and K2, keys in K3), loaded once; the other side
// streams through a two-stage cp.async ring of XOR-swizzled bfloat16 tiles
// (16-byte copies; the eight rows that one ldmatrix reads at one 16-byte
// column fall in eight bank groups), the next tile's copy in flight while
// the current one is multiplied. Scores, P and dS stay in registers: the
// C fragment of one product is rounded to bfloat16 and repacked as the A
// fragment of the next. A C fragment holds rows lane/4 and lane/4 + 8,
// columns 2*(lane%4) and +1 of each 8-column n-tile, so a row's max and
// sum reduce over the four lanes of a quad. exp is exp2f of x log2(e).
//
// Why mma.sync and not wgmma: at the LM's shape K1-K3 are bound by bytes
// (~34 / 43 / 51 MB, ~10 / 13 / 15 us); their 4.3 / 6.5 / 8.6 GFLOP take
// well under that at the warp-level tensor-core rate. What the designs
// were measured against (more warps or keys a block, deeper rings,
// skipping masked fragments on the diagonal, K and V held in registers in
// K3, key chunks of 16 or 32 in K2): PERF.md's findings.
//
// The rounding points are the plain version's (P to v's / dO's type, dS
// to k's / q's type); the sums are float32 in the tensor cores' order, so
// a result may differ from the plain version by the terms that
// ops/flash_attention.py `flash_fwd_bound`, `flash_bwd_dq_bound` and
// `flash_bwd_dkv_bound` state, one term for each rounding or sum that
// differs.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;   // 4 warps of 16 rows: 64 rows a block
constexpr int kRing = 2;          // K1's ring (3, 4 slots measured no faster)
constexpr float kLog2e = 1.4426950408889634f;

// exp(x) as the hardware's ex2 of x log2(e): two float32 roundings and
// ex2's own error (~2 ulp) where expf takes a longer exact range reduction
// (2^-22 relative in all, inside the per-term bound's allowance for exp).
__device__ __forceinline__ float exp_tc(float x) { return exp2f(x * kLog2e); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; src_bytes 0 writes 16 zero bytes
// (rows past the end of a ragged tile).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a . b for one 16 x 8 tile, k = 16.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bfloat16 in one register, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k rows 16*kk .. 16*kk+15 of a product, from the C
// fragments of n-tiles 2*kk (c0) and 2*kk+1 (c1) of the previous one.
__device__ __forceinline__ void c_to_a(const float (&c0)[4],
                                       const float (&c1)[4],
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// Element offset of 16-byte column c of row r in a swizzled [rows][D]
// bfloat16 tile: the column is XORed with the row (for D = 32, where two
// rows share a 128-byte line, with the row pair).
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kCols = D / 8;
  const int pc = kCols >= 8 ? (c ^ (r & 7)) : (c ^ ((r >> 1) & 3));
  return r * D + pc * 8;
}

// Rows [row0, row0 + 64) of the first W columns of a row-major [total, LD]
// bfloat16 matrix into a swizzled [64][W] tile with cp.async; rows past
// `total` are zeros.
template <int W, int LD = W>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int row0, int total) {
  constexpr int kCols = W / 8;
  for (int e = threadIdx.x; e < 64 * kCols; e += kTcThreads) {
    const int r = e / kCols, c = e % kCols;
    const int g = row0 + r;
    const bf16* from = src + (long long)min(g, total - 1) * LD + c * 8;
    cp_async16(smem_u32(dst + swz<W>(r, c)), from, g < total ? 16 : 0);
  }
}

// Head dim 256. Held whole, a block's outputs and operand fragments pass
// the 255 registers a thread may have (K1: Q's fragments and O, 64 + 128,
// plus the scores; K2: Q's and dO's fragments and dQ, 128 + 128; K3: dK and
// dV, 2 x 128), so at D = 256 each bfloat16 block computes the output
// columns of one half of D (a third grid dimension of 2): the scores (and
// dP) over all of D, recomputed by both halves, and O, dQ or dK and dV over
// its 128 columns only; Q's and dO's A fragments are re-read from shared
// memory with ldmatrix for each product instead of held. DH is the output
// columns of a block.
template <int D>
__host__ __device__ constexpr int out_cols() {
  return D <= 128 ? D : 128;
}

__device__ __forceinline__ void copy4(const uint32_t (&s)[4],
                                      uint32_t (&d)[4]) {
  d[0] = s[0];
  d[1] = s[1];
  d[2] = s[2];
  d[3] = s[3];
}

// Element i (0 <= i < 64) of a 64-long run of 32-bit values starting at
// row0 into dst[i]; past `total`, zero. Threads outside [0, 64) do nothing.
__device__ __forceinline__ void load_vec_async(void* dst, const void* src,
                                               int row0, int total, int i) {
  if (i < 0 || i >= 64) return;
  const int g = row0 + i;
  const char* from = static_cast<const char*>(src) + 4ll * min(g, total - 1);
  cp_async4(smem_u32(static_cast<char*>(dst) + 4 * i), from,
            g < total ? 4 : 0);
}

// Where each lane points ldmatrix in a swizzled [rows][D] tile, as a
// byte offset for k columns 0..15 of rows 0..15: `a_off` for the A
// fragment (and, with .trans, for the B fragments of two n-tiles of
// columns whose k rows are the tile's rows), `b_off` for the B fragments of
// two n-tiles whose n rows are the tile's rows. Rows rb.. (rb a multiple
// of 16) and columns 16*kk.. are then at base + rb*2D + (off ^ 32*kk):
// the swizzle XORs the 16-byte column with bits of the row below 16, so
// moving 16 columns flips one bit of the offset and moving 16 rows adds.
template <int D>
__device__ __forceinline__ uint32_t a_off(int lane) {
  return 2 * swz<D>((lane & 7) + ((lane >> 3) & 1) * 8, lane >> 4);
}
template <int D>
__device__ __forceinline__ uint32_t b_off(int lane) {
  return 2 * swz<D>((lane & 7) + (lane >> 4) * 8, (lane >> 3) & 1);
}
template <int D>
__device__ __forceinline__ uint32_t frag_at(uint32_t base, int rb,
                                            uint32_t off, int kk) {
  return base + rb * (2 * D) + (off ^ (32 * kk));
}

// Least and greatest of ids[row0 .. row0 + n), reduced within the warp, so
// each warp reaches the same block-uniform decision without a barrier.
__device__ __forceinline__ void warp_id_range(const int* ids, int row0, int n,
                                              int lane, int& lo, int& hi) {
  lo = INT_MAX;
  hi = INT_MIN;
  for (int i = lane; i < n; i += 32) {
    const int v = __ldg(ids + row0 + i);
    lo = min(lo, v);
    hi = max(hi, v);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// K1, bfloat16. Grid (batch*head, q tile, half of D) with the last
// (longest causal) q tiles launched first, so the tail wave is made of
// short blocks. Shared memory: Q [64][D], then two stages of K [64][D] and
// of V's DH columns of the block's half [64][DH].
template <int D>
__global__ void __launch_bounds__(kTcThreads) flash_fwd_tc_kernel(Args a) {
  constexpr int DH = out_cols<D>();   // output columns of a block
  constexpr bool kHoldQ = D <= 128;   // Q's fragments in registers
  constexpr int KC = D / 16;    // k chunks of Q . K^T
  constexpr int KB = kBK;       // keys per tile
  constexpr int S = kRing;      // tiles in the cp.async ring
  constexpr int NS = KB / 8;    // n-tiles of a score tile
  constexpr int NO = DH / 8;    // n-tiles of the block's output
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Ks = Qs + kBQ * D;       // [S][KB][D]
  bf16* Vs = Ks + S * KB * D;    // [S][KB][DH]

  const int Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int bh = blockIdx.x, b = bh / a.H;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int half = D > 128 ? blockIdx.z : 0;   // columns half * DH ..
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kBQ, nqr = min(kBQ, Tq - q0);
  const bf16* q = static_cast<const bf16*>(a.q) + (long long)bh * Tq * D;
  const bf16* k = static_cast<const bf16*>(a.k) + (long long)bh * Tk * D;
  const bf16* v =
      static_cast<const bf16*>(a.v) + (long long)bh * Tk * D + half * DH;
  const bool seg = a.qseg != nullptr;
  const int* qseg = seg ? a.qseg + (long long)b * Tq : nullptr;
  const int* kvseg = seg ? a.kvseg + (long long)b * Tk : nullptr;

  load_tile_async<D>(Qs, q, q0, Tq);
  cp_async_commit();

  const int r0 = warp * 16 + g;   // this thread's rows: q0 + r0 and + 8
  int qlo = 0, qhi = 0, myq[2] = {0, 0};
  if (seg) {
    warp_id_range(qseg, q0, nqr, lane, qlo, qhi);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      myq[i] = __ldg(qseg + min(q0 + r0 + 8 * i, Tq - 1));
  }
  // key tiles the block's rows see: all, or under causal masking those up
  // to the last key its last row sees
  int n_kt = (Tk + KB - 1) / KB;
  if (a.causal) {
    const int last_key = q0 + nqr - 1 + off;
    n_kt = last_key < 0 ? 0 : min(n_kt, last_key / KB + 1);
  }
  // the first live key tile at or after kt (segments: the id ranges meet)
  auto next_live = [&](int kt) {
    if (seg) {
      for (; kt < n_kt; ++kt) {
        int klo, khi;
        warp_id_range(kvseg, kt * KB, min(KB, Tk - kt * KB), lane, klo, khi);
        if (!(qhi < klo || qlo > khi)) break;
      }
    }
    return kt;
  };

  // the live tiles in order go to ring slots 0, 1, ...; `ahead` is the
  // next one to load, S - 1 tiles ahead of the one being multiplied
  auto load_kv = [&](int slot, int tile) {
    load_tile_async<D>(Ks + slot * KB * D, k, tile * KB, Tk);
    load_tile_async<DH, D>(Vs + slot * KB * DH, v, tile * KB, Tk);
  };
  int kt = next_live(0), ahead = kt;
#pragma unroll
  for (int st = 0; st < S - 1; ++st) {
    if (ahead < n_kt) {
      load_kv(st, ahead);
      ahead = next_live(ahead + 1);
    }
    cp_async_commit();
  }
  cp_async_wait<S - 1>();   // Q has landed
  __syncthreads();
  const uint32_t aoff = a_off<D>(lane), boff = b_off<D>(lane);
  const uint32_t voff = a_off<DH>(lane);
  uint32_t qf[KC][4];   // (unused, so not allocated, where !kHoldQ)
  if constexpr (kHoldQ) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk)
      ldsm_x4(frag_at<D>(smem_u32(Qs), warp * 16, aoff, kk), qf[kk]);
  }

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  int slot = 0;
  while (kt < n_kt) {
    if (ahead < n_kt) {   // into the slot the previous tile used
      load_kv((slot + S - 1) % S, ahead);
      ahead = next_live(ahead + 1);
    }
    cp_async_commit();
    cp_async_wait<S - 1>();   // this tile's K and V have landed
    __syncthreads();
    const uint32_t Kt = smem_u32(Ks + slot * KB * D);
    const uint32_t Vt = smem_u32(Vs + slot * KB * DH);
    const int k0 = kt * KB;

    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    // (fully unrolled at D = 256, ptxas hoists the 16 chunks' fragment
    // loads and spills; 4 at a time it does not)
#pragma unroll(kHoldQ ? KC : 4)
    for (int kk = 0; kk < KC; ++kk) {
      uint32_t qa[4];
      if constexpr (kHoldQ)
        copy4(qf[kk], qa);
      else
        ldsm_x4(frag_at<D>(smem_u32(Qs), warp * 16, aoff, kk), qa);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t bk[4];
        ldsm_x4(frag_at<D>(Kt, np * 16, boff, kk), bk);
        mma_bf16(s[2 * np], qa, bk[0], bk[1]);
        mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
      }
    }

    // masks, only on the tiles that need them (a block-uniform test)
    const bool edge =
        seg || k0 + KB > Tk || (a.causal && k0 + KB - 1 > q0 + off);
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bool ok = true;
        if (edge) {
          const int kp = k0 + 8 * j + 2 * t + (e & 1);
          const int qp = q0 + r0 + 8 * (e >> 1);
          ok = kp < Tk;
          if (a.causal) ok = ok && qp + off >= kp;
          if (seg) ok = ok && myq[e >> 1] == __ldg(kvseg + min(kp, Tk - 1));
        }
        s[j][e] = ok ? s[j][e] * a.scale : kNegInf;
      }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < NS; ++j)
        mc = fmaxf(mc, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      const float mn = fmaxf(m[i], quad_max(mc));
      const float alpha = exp_tc(m[i] - mn);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          // a row with nothing visible so far has m == s == -1e30: its
          // dead entries must not count as exp(0) = 1
          const float p =
              s[j][e] > kNegInf * 0.5f ? exp_tc(s[j][e] - mn) : 0.f;
          rs += p;
          s[j][e] = p;
        }
      l[i] = l[i] * alpha + quad_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < NO; ++j) {
        o[j][2 * i] *= alpha;
        o[j][2 * i + 1] *= alpha;
      }
    }

    // O += P . V: P rounded to bfloat16 straight from the score fragments,
    // V's B fragments through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < KB / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(s[2 * kk], s[2 * kk + 1], pa);
#pragma unroll
      for (int dd = 0; dd < NO / 2; ++dd) {
        uint32_t bv[4];
        ldsm_x4_t(frag_at<DH>(Vt, kk * 16, voff, dd), bv);
        mma_bf16(o[2 * dd], pa, bv[0], bv[1]);
        mma_bf16(o[2 * dd + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();   // every warp is done with this slot
    slot = (slot + 1) % S;
    kt = next_live(kt + 1);
  }
  cp_async_wait<0>();

  bf16* out =
      static_cast<bf16*>(a.out) + (long long)bh * Tq * D + half * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + 8 * i;
    if (qp >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(out + (long long)qp * D + 8 * j + 2 * t) =
          pack_bf16(o[j][2 * i] / den, o[j][2 * i + 1] / den);
    if (a.lse_out != nullptr && t == 0 && half == 0)
      a.lse_out[(long long)bh * Tq + qp] = m[i] + logf(den);
  }
}

// K3, bfloat16. Grid (batch*head, key tile, half of D); each warp owns 16
// keys and
// works transposed (keys as rows), so that every intermediate is a C
// fragment that becomes the next product's A fragment:
//   S^T = K Q^T, P^T = exp(S^T scale - lse) where visible, dV += P^T dO,
//   dP^T = V dO^T, dS^T = P^T (dP^T - delta) scale, dK += dS^T Q.
// K and V are loaded once; Q, dO, lse, delta (and the query ids) of each
// live q tile come through a two-stage cp.async ring, and each q tile is
// taken in chunks of QC queries. dK and dV stay in registers (64 floats a
// thread at D = 64); K's and V's A fragments are read from shared memory
// for each chunk rather than held, and the chunk's products run in two
// halves (S, P, dV, then dP, dS, dK), so that a thread needs at most 168
// registers and three blocks fit on an SM. At D = 256 a block computes
// the DH columns of dK and dV of its half of D (out_cols).
template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 3 : 1)
    flash_dkv_tc_kernel(Args a) {
  constexpr int DH = out_cols<D>();   // output columns of a block
  constexpr int KC = D / 16;          // k chunks over D
  constexpr int NO = DH / 8;          // n-tiles of the block's dK, dV
  constexpr int HC = DH / 16;         // 16-column chunks of a half
  constexpr int QC = 16;              // queries per chunk
  constexpr int NQ = QC / 8;          // n-tiles of a chunk of S^T
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);   // [kBK][D]
  bf16* Vs = Ks + kBK * D;                       // [kBK][D]
  bf16* Qs = Vs + kBK * D;                       // [2][kBQ][D]
  bf16* Gs = Qs + 2 * kBQ * D;                   // dO [2][kBQ][D]
  float* lse_s = reinterpret_cast<float*>(Gs + 2 * kBQ * D);  // [2][kBQ]
  float* dl_s = lse_s + 2 * kBQ;                              // [2][kBQ]
  int* qid_s = reinterpret_cast<int*>(dl_s + 2 * kBQ);        // [2][kBQ]

  const int Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int bh = blockIdx.x, b = bh / a.H;
  const int kt = blockIdx.y;   // causal: low key tiles see the most rows
  const int half = D > 128 ? blockIdx.z : 0;   // columns half * DH ..
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int k0 = kt * kBK, nkr = min(kBK, Tk - k0);
  const bool seg = a.qseg != nullptr;
  // (pointers into the inputs are formed where they are used, from the
  // kernel's parameters, so that no register holds them across the loop)
  load_tile_async<D>(Ks, static_cast<const bf16*>(a.k) + (long long)bh * Tk * D,
                     k0, Tk);
  load_tile_async<D>(Vs, static_cast<const bf16*>(a.v) + (long long)bh * Tk * D,
                     k0, Tk);
  cp_async_commit();

  const int r0 = warp * 16 + g;   // this thread's keys: k0 + r0 and + 8
  int klo = 0, khi = 0, myk[2] = {0, 0};
  if (seg) {
    const int* kvseg = a.kvseg + (long long)b * Tk;
    warp_id_range(kvseg, k0, nkr, lane, klo, khi);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      myk[i] = __ldg(kvseg + min(k0 + r0 + 8 * i, Tk - 1));
  }
  const int n_qt = (Tq + kBQ - 1) / kBQ;
  // the first live q tile at or after qt: causal, the tile's last row sees
  // this tile's first key; segments, the id ranges meet
  auto next_live = [&](int qt) {
    for (; qt < n_qt; ++qt) {
      const int q0 = qt * kBQ, nqr = min(kBQ, Tq - q0);
      if (a.causal && q0 + nqr - 1 + off < k0) continue;
      if (seg) {
        int qlo, qhi;
        warp_id_range(a.qseg + (long long)b * Tq, q0, nqr, lane, qlo, qhi);
        if (qhi < klo || qlo > khi) continue;
      }
      break;
    }
    return qt;
  };
  auto load_stage = [&](int st, int qt) {
    const int q0 = qt * kBQ;
    const long long qoff = (long long)blockIdx.x * Tq * D;
    const long long roff = (long long)blockIdx.x * Tq;
    load_tile_async<D>(Qs + st * kBQ * D,
                       static_cast<const bf16*>(a.q) + qoff, q0, Tq);
    load_tile_async<D>(Gs + st * kBQ * D,
                       static_cast<const bf16*>(a.dout) + qoff, q0, Tq);
    load_vec_async(lse_s + st * kBQ, a.lse_in + roff, q0, Tq, tid);
    load_vec_async(dl_s + st * kBQ, a.delta + roff, q0, Tq, tid - kBQ);
    if (seg)
      load_vec_async(qid_s + st * kBQ, a.qseg + (long long)b * Tq, q0, Tq,
                     tid);
  };

  int qt = next_live(0);
  if (qt < n_qt) load_stage(0, qt);
  cp_async_commit();

  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const uint32_t aoff = a_off<D>(lane), boff = b_off<D>(lane);
  const uint32_t Ka = smem_u32(Ks), Va = smem_u32(Vs);

  int stage = 0;
  while (qt < n_qt) {
    const int nxt = next_live(qt + 1);
    if (nxt < n_qt) load_stage(stage ^ 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();   // this stage (and, the first time, K and V)
    __syncthreads();
    const uint32_t Qt = smem_u32(Qs + stage * kBQ * D);
    const uint32_t Gt = smem_u32(Gs + stage * kBQ * D);
    const float* lse_t = lse_s + stage * kBQ;
    const float* dl_t = dl_s + stage * kBQ;
    const int* qid_t = qid_s + stage * kBQ;
    const int q0 = qt * kBQ;
    const bool edge = seg || q0 + kBQ > Tq || k0 + kBK > Tk ||
                      (a.causal && k0 + kBK - 1 > q0 + off);

#pragma unroll
    for (int qc = 0; qc < kBQ / QC; ++qc) {
      // S^T of this chunk, [16 keys][QC queries], then P^T in place
      float s[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        uint32_t ka[4];
        ldsm_x4(frag_at<D>(Ka, warp * 16, aoff, kk), ka);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bq[4];
          ldsm_x4(frag_at<D>(Qt, qc * QC + np * 16, boff, kk), bq);
          mma_bf16(s[2 * np], ka, bq[0], bq[1]);
          mma_bf16(s[2 * np + 1], ka, bq[2], bq[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lq = qc * QC + 8 * j + 2 * t + (e & 1);
          bool ok = true;
          if (edge) {
            const int qp = q0 + lq, kp = k0 + r0 + 8 * (e >> 1);
            ok = qp < Tq && kp < Tk;
            if (a.causal) ok = ok && qp + off >= kp;
            if (seg) ok = ok && qid_t[lq] == myk[e >> 1];
          }
          s[j][e] = ok ? exp_tc(s[j][e] * a.scale - lse_t[lq]) : 0.f;
        }

      // dV += P^T dO: P^T rounded to bfloat16 from its fragments, dO's B
      // fragments through ldmatrix.trans
#pragma unroll
      for (int kq = 0; kq < QC / 16; ++kq) {
        uint32_t pa[4];
        c_to_a(s[2 * kq], s[2 * kq + 1], pa);
#pragma unroll
        for (int dd = 0; dd < NO / 2; ++dd) {
          uint32_t bg[4];
          ldsm_x4_t(frag_at<D>(Gt, qc * QC + kq * 16, aoff, half * HC + dd),
                    bg);
          mma_bf16(dv[2 * dd], pa, bg[0], bg[1]);
          mma_bf16(dv[2 * dd + 1], pa, bg[2], bg[3]);
        }
      }

      // dP^T = V dO^T, then dS^T in place
      float dp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        uint32_t va[4];
        ldsm_x4(frag_at<D>(Va, warp * 16, aoff, kk), va);
#pragma unroll
        for (int np = 0; np < NQ / 2; ++np) {
          uint32_t bg[4];
          ldsm_x4(frag_at<D>(Gt, qc * QC + np * 16, boff, kk), bg);
          mma_bf16(dp[2 * np], va, bg[0], bg[1]);
          mma_bf16(dp[2 * np + 1], va, bg[2], bg[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lq = qc * QC + 8 * j + 2 * t + (e & 1);
          dp[j][e] = s[j][e] * (dp[j][e] - dl_t[lq]) * a.scale;
        }

      // dK += dS^T Q: dS^T rounded to bfloat16 from its fragments, Q's B
      // fragments through ldmatrix.trans
#pragma unroll
      for (int kq = 0; kq < QC / 16; ++kq) {
        uint32_t sa[4];
        c_to_a(dp[2 * kq], dp[2 * kq + 1], sa);
#pragma unroll
        for (int dd = 0; dd < NO / 2; ++dd) {
          uint32_t bq[4];
          ldsm_x4_t(frag_at<D>(Qt, qc * QC + kq * 16, aoff, half * HC + dd),
                    bq);
          mma_bf16(dk[2 * dd], sa, bq[0], bq[1]);
          mma_bf16(dk[2 * dd + 1], sa, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this stage
    stage ^= 1;
    qt = nxt;
  }
  cp_async_wait<0>();

  const long long koff = (long long)blockIdx.x * Tk * D + half * DH;
  bf16* dko = static_cast<bf16*>(a.dk) + koff;
  bf16* dvo = static_cast<bf16*>(a.dv) + koff;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int kp = k0 + r0 + 8 * i;
    if (kp >= Tk) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const long long at = (long long)kp * D + 8 * j + 2 * t;
      *reinterpret_cast<uint32_t*>(dko + at) =
          pack_bf16(dk[j][2 * i], dk[j][2 * i + 1]);
      *reinterpret_cast<uint32_t*>(dvo + at) =
          pack_bf16(dv[j][2 * i], dv[j][2 * i + 1]);
    }
  }
}

// K2, bfloat16. Grid (batch*head, q tile, half of D) with the last
// (longest causal) q tiles launched first, as K1. Each warp owns 16 query rows; Q and dO of
// the block's tile come in once and their A fragments stay in registers,
// with lse and delta of the thread's two rows. K and V tiles of 64 keys
// stream through a two-slot cp.async ring, and each tile is taken in
// chunks of KN keys:
//   S = Q K^T and dP = dO V^T (K's and V's B fragments by ldmatrix),
//   P = exp(S scale - lse) where visible, dS = P (dP - delta) scale in
//   place on the C fragment, dQ += dS K (dS repacked as an A fragment, K's
//   B fragments by ldmatrix.trans on the same swizzled tile).
// dQ stays in registers (D / 2 floats a thread) and is written once. The
// chunk is 16 keys, so that S and dP of a chunk, the Q and dO fragments
// and dQ fit in 128 registers at D = 64 and four blocks share an SM (32
// keys a chunk took 168 registers, three blocks an SM, and was slower).
// Shared memory: Q [64][D], dO [64][D], then two slots of K and V. At
// D = 256 a block computes the DH columns of dQ of its half of D and reads
// Q's and dO's fragments from shared memory for each chunk (out_cols).
template <int D>
__global__ void __launch_bounds__(kTcThreads, D <= 64 ? 4 : 1)
    flash_dq_tc_kernel(Args a) {
  constexpr int DH = out_cols<D>();       // output columns of a block
  constexpr bool kHold = D <= 128;        // Q's, dO's fragments held
  constexpr int KC = D / 16;              // k chunks of S and dP over D
  constexpr int NO = DH / 8;              // n-tiles of the block's dQ
  constexpr int HC = DH / 16;             // 16-column chunks of a half
  constexpr int KB = kBK;                 // keys per tile
  constexpr int KN = 16;                  // keys per chunk
  constexpr int NS = KN / 8;              // n-tiles of a chunk of S, dP
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);   // [kBQ][D]
  bf16* Gs = Qs + kBQ * D;                       // dO [kBQ][D]
  bf16* Ks = Gs + kBQ * D;                       // [2][KB][D]
  bf16* Vs = Ks + 2 * KB * D;                    // [2][KB][D]

  const int Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int bh = blockIdx.x, b = bh / a.H;
  const int qb = gridDim.y - 1 - blockIdx.y;
  const int half = D > 128 ? blockIdx.z : 0;   // columns half * DH ..
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kBQ, nqr = min(kBQ, Tq - q0);
  const long long qoff = (long long)bh * Tq * D;
  const bf16* k = static_cast<const bf16*>(a.k) + (long long)bh * Tk * D;
  const bf16* v = static_cast<const bf16*>(a.v) + (long long)bh * Tk * D;
  const bool seg = a.qseg != nullptr;
  const int* qseg = seg ? a.qseg + (long long)b * Tq : nullptr;
  const int* kvseg = seg ? a.kvseg + (long long)b * Tk : nullptr;

  load_tile_async<D>(Qs, static_cast<const bf16*>(a.q) + qoff, q0, Tq);
  load_tile_async<D>(Gs, static_cast<const bf16*>(a.dout) + qoff, q0, Tq);
  cp_async_commit();

  // this thread's rows q0 + r0 and + 8 (rows past Tq read the last row's
  // lse and delta; their dQ is never written)
  const int r0 = warp * 16 + g;
  float lse[2], dl[2];
  int myq[2] = {0, 0};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = min(q0 + r0 + 8 * i, Tq - 1);
    lse[i] = __ldg(a.lse_in + (long long)bh * Tq + qp);
    dl[i] = __ldg(a.delta + (long long)bh * Tq + qp);
    if (seg) myq[i] = __ldg(qseg + qp);
  }
  int qlo = 0, qhi = 0;
  if (seg) warp_id_range(qseg, q0, nqr, lane, qlo, qhi);
  const int n_kt = key_tiles(a, q0, nqr);
  // the first live key tile at or after kt (segments: the id ranges meet)
  auto next_live = [&](int kt) {
    if (seg) {
      for (; kt < n_kt; ++kt) {
        int klo, khi;
        warp_id_range(kvseg, kt * KB, min(KB, Tk - kt * KB), lane, klo, khi);
        if (!(qhi < klo || qlo > khi)) break;
      }
    }
    return kt;
  };
  auto load_kv = [&](int slot, int tile) {
    load_tile_async<D>(Ks + slot * KB * D, k, tile * KB, Tk);
    load_tile_async<D>(Vs + slot * KB * D, v, tile * KB, Tk);
  };

  int kt = next_live(0), ahead = kt;
  if (ahead < n_kt) {
    load_kv(0, ahead);
    ahead = next_live(ahead + 1);
  }
  cp_async_commit();
  cp_async_wait<1>();   // Q and dO have landed
  __syncthreads();
  const uint32_t aoff = a_off<D>(lane), boff = b_off<D>(lane);
  uint32_t qf[KC][4], gf[KC][4];   // (not allocated where !kHold)
  if constexpr (kHold) {
#pragma unroll
    for (int kk = 0; kk < KC; ++kk) {
      ldsm_x4(frag_at<D>(smem_u32(Qs), warp * 16, aoff, kk), qf[kk]);
      ldsm_x4(frag_at<D>(smem_u32(Gs), warp * 16, aoff, kk), gf[kk]);
    }
  }

  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  int slot = 0;
  while (kt < n_kt) {
    if (ahead < n_kt) {   // into the slot the previous tile used
      load_kv(slot ^ 1, ahead);
      ahead = next_live(ahead + 1);
    }
    cp_async_commit();
    cp_async_wait<1>();   // this tile's K and V have landed
    __syncthreads();
    const uint32_t Kt = smem_u32(Ks + slot * KB * D);
    const uint32_t Vt = smem_u32(Vs + slot * KB * D);
    const int k0 = kt * KB;
    // masks, only on the tiles that need them (a block-uniform test)
    const bool edge =
        seg || k0 + KB > Tk || (a.causal && k0 + KB - 1 > q0 + off);

#pragma unroll
    for (int c = 0; c < KB / KN; ++c) {
      float s[NS][4], dp[NS][4];
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KC; ++kk) {
        uint32_t qa[4], ga[4];
        if constexpr (kHold) {
          copy4(qf[kk], qa);
          copy4(gf[kk], ga);
        } else {
          ldsm_x4(frag_at<D>(smem_u32(Qs), warp * 16, aoff, kk), qa);
          ldsm_x4(frag_at<D>(smem_u32(Gs), warp * 16, aoff, kk), ga);
        }
#pragma unroll
        for (int np = 0; np < NS / 2; ++np) {
          uint32_t bk[4], bv[4];
          ldsm_x4(frag_at<D>(Kt, c * KN + np * 16, boff, kk), bk);
          ldsm_x4(frag_at<D>(Vt, c * KN + np * 16, boff, kk), bv);
          mma_bf16(s[2 * np], qa, bk[0], bk[1]);
          mma_bf16(s[2 * np + 1], qa, bk[2], bk[3]);
          mma_bf16(dp[2 * np], ga, bv[0], bv[1]);
          mma_bf16(dp[2 * np + 1], ga, bv[2], bv[3]);
        }
      }

      // P where visible, then dS in place on S's fragment
#pragma unroll
      for (int j = 0; j < NS; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          bool ok = true;
          if (edge) {
            const int kp = k0 + c * KN + 8 * j + 2 * t + (e & 1);
            const int qp = q0 + r0 + 8 * i;
            ok = kp < Tk;
            if (a.causal) ok = ok && qp + off >= kp;
            if (seg) ok = ok && myq[i] == __ldg(kvseg + min(kp, Tk - 1));
          }
          const float p = ok ? exp_tc(s[j][e] * a.scale - lse[i]) : 0.f;
          s[j][e] = p * (dp[j][e] - dl[i]) * a.scale;
        }

      // dQ += dS K: dS rounded to bfloat16 from its fragments, K's B
      // fragments through ldmatrix.trans
#pragma unroll
      for (int kq = 0; kq < KN / 16; ++kq) {
        uint32_t sa[4];
        c_to_a(s[2 * kq], s[2 * kq + 1], sa);
#pragma unroll
        for (int dd = 0; dd < NO / 2; ++dd) {
          uint32_t bk[4];
          ldsm_x4_t(frag_at<D>(Kt, c * KN + kq * 16, aoff, half * HC + dd),
                    bk);
          mma_bf16(dq[2 * dd], sa, bk[0], bk[1]);
          mma_bf16(dq[2 * dd + 1], sa, bk[2], bk[3]);
        }
      }
    }
    __syncthreads();   // every warp is done with this slot
    slot ^= 1;
    kt = next_live(kt + 1);
  }
  cp_async_wait<0>();

  bf16* dqo = static_cast<bf16*>(a.dq) + qoff + half * DH;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + r0 + 8 * i;
    if (qp >= Tq) continue;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<uint32_t*>(dqo + (long long)qp * D + 8 * j + 2 * t) =
          pack_bf16(dq[j][2 * i], dq[j][2 * i + 1]);
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
  constexpr size_t BQ = f32_bq<D>();
  return sizeof(float) * (2 * (BQ + kBK) * (D + 1) + BQ * kPS + 2 * BQ) +
         sizeof(int) * (BQ + kBK);
}
template <int D>
constexpr size_t dkv_smem() {
  constexpr size_t BQ = f32_bq<D>();
  return sizeof(float) * (2 * (BQ + kBK) * (D + 1) + 2 * BQ * kPS + 2 * BQ) +
         sizeof(int) * (BQ + kBK);
}
template <int D>
constexpr size_t fwd_tc_smem() {
  return sizeof(bf16) * ((size_t)(kBQ + kRing * kBK) * D +
                         (size_t)kRing * kBK * out_cols<D>());
}
template <int D>
constexpr size_t dq_tc_smem() {
  return sizeof(bf16) * (size_t)(2 * kBQ + 4 * kBK) * D;
}
template <int D>
constexpr size_t dkv_tc_smem() {
  return sizeof(bf16) * (size_t)(2 * kBK + 4 * kBQ) * D +
         (sizeof(float) * 2 + sizeof(int)) * 2 * kBQ;
}

// ---------------------------------------------------------------------------
// K1-K3 for head dims above 256: the wide-head route. These three kernels
// take float32 K1-K3 and bfloat16 K3; bfloat16 K1 and K2 run on the tensor
// cores (flash_fwd_wide_tc_kernel, flash_dq_wide_tc_kernel, further below).
// Float32 arithmetic inside (plain FMAs on the CUDA cores, as the float32
// kernels above), which keeps float32 exact where tf32 would not. D is a
// runtime argument, a multiple of kWO (the wrapper zero-pads q, k, v and
// dO, which is exact).
//
// No tile scales with D, so shared memory is the same for every D:
//   - the scores (and dP) are summed over all of D in chunks of kWC
//     columns: each chunk of the block's own rows (queries in K1 and K2,
//     keys in K3) and of the streamed side is staged through shared
//     memory, and the block accumulates s (and dp) in registers across
//     the chunks;
//   - each block writes one kWO-column slice of O, dQ or dK and dV, so
//     the grid's z dimension is D / kWO; the blocks of one row tile
//     recompute its scores, which a slice of 128 columns over 64-column
//     chunks costs about as much as the slice's own product.
// The rounding points are the plain version's: P to v's type before P.V
// (to dO's before dV), dS to k's type before dS.K (to q's before dS^T.Q).
// bfloat16 inputs (K3) are widened exactly to float32 as they are staged;
// sums are float32, so the result differs from the plain version by sums
// in another order only, well inside flash_*_bound. A simple design that
// is right: its speed is later work (PERF.md).
// ---------------------------------------------------------------------------
constexpr int kWC = 64;           // D columns a chunk stages
constexpr int kWLD = kWC + 1;     // row stride of a chunk tile
constexpr int kWO = 128;          // output columns a block owns
constexpr int kWNJ = kWO / 16;    // output columns a thread owns

template <typename T>
__device__ __forceinline__ float ld_f(const T* p, long long i) {
  if constexpr (std::is_same<T, float>::value) return p[i];
  else return __bfloat162float(p[i]);
}

template <typename T>
__device__ __forceinline__ void st_f(T* p, long long i, float v) {
  if constexpr (std::is_same<T, float>::value) p[i] = v;
  else p[i] = __float2bfloat16(v);
}

// v rounded to T and back: the plain version's cast before a product.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, float>::value) return v;
  else return __bfloat162float(__float2bfloat16(v));
}

// Columns [c0, c0 + nc) of rows [row0, row0 + n) of a row-major [total, D]
// matrix into a float tile with row stride ld; rows past `total` read as 0.
template <typename T>
__device__ __forceinline__ void load_cols(float* dst, int ld, const T* src,
                                          int D, int row0, int total, int n,
                                          int c0, int nc) {
  for (int e = threadIdx.x; e < n * nc; e += kThreads) {
    const int r = e / nc, c = e % nc;
    const int g = row0 + r;
    dst[r * ld + c] = g < total ? ld_f(src, (long long)g * D + c0 + c) : 0.f;
  }
}

// s[i][j] (and dp[i][j] when G and V are given) += the dot over one chunk
// of rows 4*ty+i of A (and G) with rows tx+16j of B (and V), all
// [64][kWLD] chunk tiles.
template <bool kDp>
__device__ __forceinline__ void chunk_dots(const float* A, const float* B,
                                           const float* G, const float* V,
                                           float (&s)[4][4],
                                           float (&dp)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
#pragma unroll 8
  for (int d = 0; d < kWC; ++d) {
    float qa[4], kc[4], ga[4], vc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qa[i] = A[(ty * 4 + i) * kWLD + d];
      if constexpr (kDp) ga[i] = G[(ty * 4 + i) * kWLD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kc[j] = B[(tx + 16 * j) * kWLD + d];
      if constexpr (kDp) vc[j] = V[(tx + 16 * j) * kWLD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qa[i], kc[j], s[i][j]);
        if constexpr (kDp) dp[i][j] = fmaf(ga[i], vc[j], dp[i][j]);
      }
  }
}

// K1, wide. One block per (q tile, batch*head, kWO-column slice of O).
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_fwd_wide_kernel(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                // Q chunk [kBQ][kWLD]
  float* Ks = Qs + kBQ * kWLD;     // K chunk [kBK][kWLD]
  float* Vs = Ks + kBK * kWLD;     // V slice [kBK][kWO]
  float* Ps = Vs + kBK * kWO;      // [kBQ][kPS]
  int* qid = reinterpret_cast<int*>(Ps + kBQ * kPS);  // [kBQ]
  int* kid = qid + kBQ;                               // [kBK]

  const int D = a.D, Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int qb = gridDim.x - 1 - blockIdx.x;   // longest causal rows first
  const int bh = blockIdx.y, b = bh / a.H, c0 = blockIdx.z * kWO;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qb * kBQ, nqr = min(kBQ, Tq - q0);
  const T* q = static_cast<const T*>(a.q) + (long long)bh * Tq * D;
  const T* k = static_cast<const T*>(a.k) + (long long)bh * Tk * D;
  const T* v = static_cast<const T*>(a.v) + (long long)bh * Tk * D;
  const bool seg = a.qseg != nullptr;

  if (seg) load_ids(qid, a.qseg + (long long)b * Tq, q0, Tq, kBQ);
  __syncthreads();
  int qlo = 0, qhi = 0;
  int myq[4] = {0, 0, 0, 0};
  if (seg) {
    id_range(qid, nqr, qlo, qhi);
#pragma unroll
    for (int i = 0; i < 4; ++i) myq[i] = qid[ty * 4 + i];
  }

  float m[4], l[4], acc[4][kWNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kWNJ; ++c) acc[i][c] = 0.f;
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
    float s[4][4], unused[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWC) {
      __syncthreads();   // the previous chunk's readers are done
      load_cols(Qs, kWLD, q, D, q0, Tq, kBQ, d0, kWC);
      load_cols(Ks, kWLD, k, D, k0, Tk, kBK, d0, kWC);
      __syncthreads();
      chunk_dots<false>(Qs, Ks, nullptr, nullptr, s, unused);
    }
    load_cols(Vs, kWO, v, D, k0, Tk, kBK, c0, kWO);

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
        e = s[i][j] > kNegInf * 0.5f ? e : 0.f;
        rs += e;
        Ps[(ty * 4 + i) * kPS + tx + 16 * j] = round_to<T>(e);
      }
      l[i] = l[i] * alpha + half_warp_sum(rs);
      m[i] = mn;
#pragma unroll
      for (int c = 0; c < kWNJ; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < kBK; ++kk) {
      float pv[4], vv[kWNJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < kWNJ; ++c) vv[c] = Vs[kk * kWO + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kWNJ; ++c)
          acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  T* out = static_cast<T*>(a.out) + (long long)bh * Tq * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Tq) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kWNJ; ++c)
      st_f(out, (long long)qp * D + c0 + tx + 16 * c, acc[i][c] / den);
    if (a.lse_out != nullptr && tx == 0 && blockIdx.z == 0)
      a.lse_out[(long long)bh * Tq + qp] = m[i] + logf(den);
  }
}

// K2, wide: dQ. One block per (q tile, batch*head, kWO-column slice).
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dq_wide_kernel(Args a) {
  extern __shared__ float smem[];
  float* Qs = smem;                // Q chunk [kBQ][kWLD]
  float* Gs = Qs + kBQ * kWLD;     // dO chunk [kBQ][kWLD]
  float* Ks = Gs + kBQ * kWLD;     // K chunk [kBK][kWLD]
  float* Vs = Ks + kBK * kWLD;     // V chunk [kBK][kWLD]
  float* Kv = Vs + kBK * kWLD;     // K slice [kBK][kWO]
  float* Ss = Kv + kBK * kWO;      // dS [kBQ][kPS]
  float* lse_s = Ss + kBQ * kPS;   // [kBQ]
  float* dl_s = lse_s + kBQ;       // [kBQ]
  int* qid = reinterpret_cast<int*>(dl_s + kBQ);   // [kBQ]
  int* kid = qid + kBQ;                            // [kBK]

  const int D = a.D, Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int qb = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H, c0 = blockIdx.z * kWO;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int q0 = qb * kBQ, nqr = min(kBQ, Tq - q0);
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  const T* q = static_cast<const T*>(a.q) + qoff;
  const T* g = static_cast<const T*>(a.dout) + qoff;
  const T* k = static_cast<const T*>(a.k) + koff;
  const T* v = static_cast<const T*>(a.v) + koff;
  const bool seg = a.qseg != nullptr;

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

  float acc[4][kWNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kWNJ; ++c) acc[i][c] = 0.f;

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
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWC) {
      __syncthreads();
      load_cols(Qs, kWLD, q, D, q0, Tq, kBQ, d0, kWC);
      load_cols(Gs, kWLD, g, D, q0, Tq, kBQ, d0, kWC);
      load_cols(Ks, kWLD, k, D, k0, Tk, kBK, d0, kWC);
      load_cols(Vs, kWLD, v, D, k0, Tk, kBK, d0, kWC);
      __syncthreads();
      chunk_dots<true>(Qs, Ks, Gs, Vs, s, dp);
    }
    load_cols(Kv, kWO, k, D, k0, Tk, kBK, c0, kWO);

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
      float sv[4], kv[kWNJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) sv[i] = Ss[(ty * 4 + i) * kPS + kk];
#pragma unroll
      for (int c = 0; c < kWNJ; ++c) kv[c] = Kv[kk * kWO + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kWNJ; ++c)
          acc[i][c] = fmaf(sv[i], kv[c], acc[i][c]);
    }
  }

  T* dq = static_cast<T*>(a.dq) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + ty * 4 + i;
    if (qp >= Tq) continue;
#pragma unroll
    for (int c = 0; c < kWNJ; ++c)
      st_f(dq, (long long)qp * D + c0 + tx + 16 * c, acc[i][c]);
  }
}

// K3, wide: dK and dV. One block per (k tile, batch*head, kWO-column
// slice); query tiles stream through.
template <typename T>
__global__ void __launch_bounds__(kThreads) flash_dkv_wide_kernel(Args a) {
  extern __shared__ float smem[];
  float* Ks = smem;                // K chunk [kBK][kWLD]
  float* Vs = Ks + kBK * kWLD;     // V chunk [kBK][kWLD]
  float* Qs = Vs + kBK * kWLD;     // Q chunk [kBQ][kWLD]
  float* Gs = Qs + kBQ * kWLD;     // dO chunk [kBQ][kWLD]
  float* Qv = Gs + kBQ * kWLD;     // Q slice [kBQ][kWO]
  float* Gv = Qv + kBQ * kWO;      // dO slice [kBQ][kWO]
  float* Ps = Gv + kBQ * kWO;      // P [kBQ][kPS]
  float* Ss = Ps + kBQ * kPS;      // dS [kBQ][kPS]
  float* lse_s = Ss + kBQ * kPS;   // [kBQ]
  float* dl_s = lse_s + kBQ;       // [kBQ]
  int* qid = reinterpret_cast<int*>(dl_s + kBQ);   // [kBQ]
  int* kid = qid + kBQ;                            // [kBK]

  const int D = a.D, Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int kt = blockIdx.x;
  const int bh = blockIdx.y, b = bh / a.H, c0 = blockIdx.z * kWO;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  const int k0 = kt * kBK, nkr = min(kBK, Tk - k0);
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  const T* q = static_cast<const T*>(a.q) + qoff;
  const T* g = static_cast<const T*>(a.dout) + qoff;
  const T* k = static_cast<const T*>(a.k) + koff;
  const T* v = static_cast<const T*>(a.v) + koff;
  const bool seg = a.qseg != nullptr;

  if (seg) load_ids(kid, a.kvseg + (long long)b * Tk, k0, Tk, kBK);
  __syncthreads();
  int klo = 0, khi = 0;
  int myk[4] = {0, 0, 0, 0};
  if (seg) {
    id_range(kid, nkr, klo, khi);
#pragma unroll
    for (int j = 0; j < 4; ++j) myk[j] = kid[tx + 16 * j];
  }

  float dk[4][kWNJ], dv[4][kWNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kWNJ; ++c) dk[i][c] = dv[i][c] = 0.f;

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
    load_rows(lse_s, a.lse_in + (long long)bh * Tq, q0, Tq, kBQ);
    load_rows(dl_s, a.delta + (long long)bh * Tq, q0, Tq, kBQ);

    // rows: queries ty*4+i; columns: keys tx+16j
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
    for (int d0 = 0; d0 < D; d0 += kWC) {
      __syncthreads();
      load_cols(Qs, kWLD, q, D, q0, Tq, kBQ, d0, kWC);
      load_cols(Gs, kWLD, g, D, q0, Tq, kBQ, d0, kWC);
      load_cols(Ks, kWLD, k, D, k0, Tk, kBK, d0, kWC);
      load_cols(Vs, kWLD, v, D, k0, Tk, kBK, d0, kWC);
      __syncthreads();
      chunk_dots<true>(Qs, Ks, Gs, Vs, s, dp);
    }
    load_cols(Qv, kWO, q, D, q0, Tq, kBQ, c0, kWO);
    load_cols(Gv, kWO, g, D, q0, Tq, kBQ, c0, kWO);

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
      float pv[4], sv[4], gv[kWNJ], qv[kWNJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[qq * kPS + ty * 4 + i];
        sv[i] = Ss[qq * kPS + ty * 4 + i];
      }
#pragma unroll
      for (int c = 0; c < kWNJ; ++c) {
        gv[c] = Gv[qq * kWO + tx + 16 * c];
        qv[c] = Qv[qq * kWO + tx + 16 * c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < kWNJ; ++c) {
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
    for (int c = 0; c < kWNJ; ++c) {
      st_f(dko, (long long)kp * D + c0 + tx + 16 * c, dk[i][c]);
      st_f(dvo, (long long)kp * D + c0 + tx + 16 * c, dv[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// K1 and K2 for bfloat16 at head dims above 256, on the tensor cores.
//
// Replace, for bfloat16 and D > 256, _flash_kernel (K1) and
// _flash_bwd_dq_kernel (K2) of paddle_tpu/ops/pallas_kernels.py, with the
// semantics and rounding points listed at the head of this file.
//
// Bound, at B 2, H 8, T 512, D 512, causal: K1 moves 33.5 MB (10.0 us at
// 3.35 TB/s) for 4.3 GFLOP (4.4 us at 989 TFLOP/s), K2 42 MB (12.5 us) for
// 6.4 GFLOP (6.5 us): bytes, as at D = 64. What stands in the way at a wide
// head: a block's 64 output rows over all of D do not fit in registers
// (64 x 512 float32 sums are half an SM's register file), while every
// score of a tile sums over all of D. So D is split across a thread-block
// cluster of C = min(8, D / 128) blocks per (query tile, batch*head), block
// r owning output columns 128 r .. 128 r + 127:
//   - block r computes the partial scores (K2: and dP) of a 64 x 64 tile
//     over its own 128 columns of D with mma.sync; its slice of Q (and dO)
//     is loaded once and held as A fragments, its slices of K (and V)
//     stream through a three-slot cp.async ring of 16-byte copies, so the
//     cluster reads each byte of q, k, v (and dO) from memory once;
//   - each row has an owner (the 64 rows are dealt to the C blocks in
//     runs of R = ceil(64 / C)), into whose shared memory every block
//     writes its partial of the row through distributed shared memory;
//     the owner sums the C partials in rank order, masks and scales them,
//     and makes P with the online softmax (K1; its rows' running max and
//     sum stay in its registers) or dS = P (dP - delta) scale (K2), rounds
//     it to bfloat16 and writes it, and K1 the rows' rescaling factor,
//     into every block of the cluster (16 bytes a store): each score is
//     computed once, and every block multiplies with the same bits;
//   - every block then adds P . V (K2: dS . K) over its 128 columns on the
//     tensor cores; O and dQ stay in registers, 64 floats a thread.
// Two cluster barriers a key tile: after the partials, after P (dS); K1
// runs a product while each is in flight (its loop, below). Above D = 1024
// a cluster of 8 covers 1024 output columns, the grid holds ceil(D / 1024)
// clusters per tile, each summing the scores over all of D, block r over
// slices r, r + 8, ..., and the slices of Q and dO then stream with K's
// and V's instead of being held.
// ---------------------------------------------------------------------------
constexpr int kWCluster = 8;          // most blocks of a cluster (portable)
constexpr int kWPS = 72;              // row stride (floats) of a partial tile
constexpr int kWRing = 3;             // slots of the cp.async ring
constexpr int kWChunk = kBK * kWO;    // elements of a [64][128] slice

struct WidePlan {
  int nch;    // 128-column slices of D
  int C;      // blocks of a cluster
  int G;      // clusters per (query tile, batch*head)
  int R;      // rows of a tile each block owns (sums, softmax)
  bool hold;  // one score slice a block: Q's (dO's) fragments held
};

__host__ __device__ inline WidePlan wide_plan(int D) {
  WidePlan p;
  p.nch = D / kWO;
  p.C = p.nch < kWCluster ? p.nch : kWCluster;
  p.G = (p.nch + p.C - 1) / p.C;
  p.R = (kBQ + p.C - 1) / p.C;
  p.hold = p.G == 1;
  return p;
}

// Dynamic shared memory of K1 (fwd) or K2: the ring; the partial tiles the
// block owns, [C][R][kWPS] (K1: two buffers of S's; K2: one of S's and one
// of dP's), which first stage the held Q (and dO) slices; P (two buffers)
// or dS; and K1's rescaling factors (two buffers) and denominators.
__host__ __device__ inline size_t wide_tc_smem(bool fwd, int D) {
  const WidePlan p = wide_plan(D);
  return sizeof(bf16) * kWRing * (p.hold ? 1 : 2) * (size_t)kWChunk +
         sizeof(float) * 2 * p.C * p.R * kWPS +
         sizeof(bf16) * (fwd ? 2 : 1) * kBQ * kBK +
         (fwd ? sizeof(float) * 3 * kBQ : 0);
}

// Rows [row0, row0 + 64) of a [64][128] column slice of a row-major
// [total, ld] bfloat16 matrix (src points at the slice's first column) into
// a swizzled tile with cp.async; rows past `total` are zeros.
__device__ __forceinline__ void load_slice_async(bf16* dst, const bf16* src,
                                                 int row0, int total,
                                                 int ld) {
  constexpr int kCols = kWO / 8;
  for (int e = threadIdx.x; e < kBK * kCols; e += kTcThreads) {
    const int r = e / kCols, c = e % kCols;
    const int g = row0 + r;
    const bf16* from = src + (long long)min(g, total - 1) * ld + c * 8;
    cp_async16(smem_u32(dst + swz<kWO>(r, c)), from, g < total ? 16 : 0);
  }
}

// acc (a 16-row x 64-key C fragment per warp) += A . B^T over one
// 128-column slice: A's fragments from `af` (kHeld) or the swizzled tile at
// `at`, B's from the swizzled tile at `bt`.
template <bool kHeld>
__device__ __forceinline__ void slice_scores(float (&acc)[8][4],
                                             const uint32_t (&af)[8][4],
                                             uint32_t at, uint32_t bt,
                                             int warp, uint32_t aoff,
                                             uint32_t boff) {
#pragma unroll
  for (int kk = 0; kk < kWO / 16; ++kk) {
    uint32_t xa[4];
    if constexpr (kHeld)
      copy4(af[kk], xa);
    else
      ldsm_x4(frag_at<kWO>(at, warp * 16, aoff, kk), xa);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      uint32_t bk[4];
      ldsm_x4(frag_at<kWO>(bt, np * 16, boff, kk), bk);
      mma_bf16(acc[2 * np], xa, bk[0], bk[1]);
      mma_bf16(acc[2 * np + 1], xa, bk[2], bk[3]);
    }
  }
}

// acc (16 rows x 128 columns per warp) += X . Y with X the [64][64]
// bfloat16 tile at xt (P or dS) and Y the [64][128] slice at yt.
__device__ __forceinline__ void tile_times_slice(float (&acc)[16][4],
                                                 uint32_t xt, uint32_t yt,
                                                 int warp, int lane) {
  const uint32_t xoff = a_off<kBK>(lane), yoff = a_off<kWO>(lane);
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    uint32_t xa[4];
    ldsm_x4(frag_at<kBK>(xt, warp * 16, xoff, kk), xa);
#pragma unroll
    for (int dd = 0; dd < kWO / 16; ++dd) {
      uint32_t by[4];
      ldsm_x4_t(frag_at<kWO>(yt, kk * 16, yoff, dd), by);
      mma_bf16(acc[2 * dd], xa, by[0], by[1]);
      mma_bf16(acc[2 * dd + 1], xa, by[2], by[3]);
    }
  }
}

// The partial tile in acc into the owners' partial buffers (slot `rank`):
// this thread's rows warp*16 + g and + 8 go to dst[0] and dst[1], in the
// owners' shared memory (stores that need no reply, so their latency
// passes under the barrier that follows).
__device__ __forceinline__ void push_partial(const float (&acc)[8][4],
                                             float* const (&dst)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float2*>(dst[i] + 8 * j) =
          make_float2(acc[j][2 * i], acc[j][2 * i + 1]);
}

// The owner's view of one of its rows: the sum, in rank order, of the C
// partials of row lr ([C][R][kWPS] buffer) at this thread's keys
// 8 kq .. 8 kq + 7.
__device__ __forceinline__ void sum_partials(float (&x)[8], const float* part,
                                             int C, int R, int lr, int kq) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* at = part + lr * kWPS + 8 * kq + 4 * h;
    float4 a = *reinterpret_cast<const float4*>(at);
    for (int src = 1; src < C; ++src) {
      const float4 y =
          *reinterpret_cast<const float4*>(at + src * R * kWPS);
      a.x += y.x;
      a.y += y.y;
      a.z += y.z;
      a.w += y.w;
    }
    x[4 * h] = a.x;
    x[4 * h + 1] = a.y;
    x[4 * h + 2] = a.z;
    x[4 * h + 3] = a.w;
  }
}

// Key e (0..7) of the owner thread kq within a 64-key tile.
__device__ __forceinline__ int owner_key(int kq, int e) { return 8 * kq + e; }

// Eight bfloat16 values (this owner thread's keys of row `row`, one
// 16-byte column of the swizzled [64][64] tile `dst`) into every block of
// the cluster.
__device__ __forceinline__ void push_row_bf16(
    cooperative_groups::cluster_group& cluster, bf16* dst, int C, int row,
    int kq, const float (&x)[8]) {
  uint4 w;
  w.x = pack_bf16(x[0], x[1]);
  w.y = pack_bf16(x[2], x[3]);
  w.z = pack_bf16(x[4], x[5]);
  w.w = pack_bf16(x[6], x[7]);
  const int e = swz<kBK>(row, kq);
  for (int c = 0; c < C; ++c)
    *reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, c) + e) = w;
}

// The two halves of a cluster barrier, so that work can run between them
// (release: this thread's writes, remote ones included, are seen by every
// thread past the matching wait).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// K1, bfloat16, D > 256. Grid (G * C, batch*head, q tile) in clusters of
// C along x, the last (longest causal) q tiles launched first. kHold:
// D <= 1024 (one score slice a block, Q's fragments held), else Q's
// slices stream with K's.
//
// The steps run one tile ahead on the scores, S(t0), S(t1), O(t0), S(t2),
// O(t1), ..., O(t_last) over the live key tiles (S: the partial scores,
// one sub-step per score slice; O: P . V), and the two barriers of a tile
// are split so that a product runs while each is in flight: barrier 1 of
// tile i (its partials have landed) is arrived at before O(t_{i-1}) and
// waited for after it, by the owner step of tile i; barrier 2 (P has
// landed) is arrived at after that owner step and waited for after
// S(t_{i+1}), before O(t_i). So the partials, P and the rescaling factors
// are double-buffered, by the parity of the tile's ordinal.
template <bool kHold>
__global__ void __launch_bounds__(kTcThreads, kHold ? 2 : 1)
    flash_fwd_wide_tc_kernel(Args a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const WidePlan pl = wide_plan(a.D);
  const int D = a.D, C = pl.C, R = pl.R;
  const int rank = (int)cluster.block_rank();
  const int co = (blockIdx.x / C) * C + rank;   // output slice
  const bool has_out = co < pl.nch;
  const int nper = (pl.nch - rank + C - 1) / C;   // score slices rank + C i
  const int slot_elems = (kHold ? 1 : 2) * kWChunk;
  const int part_elems = C * R * kWPS;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);               // [3][slot]
  float* part = reinterpret_cast<float*>(ring + kWRing * slot_elems);
  // (part: [2][C][R][kWPS], the partial scores of the rows it owns)
  bf16* Pb = reinterpret_cast<bf16*>(part + 2 * part_elems);   // [2][64][64]
  float* alpha_b = reinterpret_cast<float*>(Pb + 2 * kBQ * kBK);   // [2][64]
  float* den_b = alpha_b + 2 * kBQ;                               // [64]

  const int Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int bh = blockIdx.y, b = bh / a.H;
  const int qb = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kBQ, nqr = min(kBQ, Tq - q0);
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  const bf16* q = static_cast<const bf16*>(a.q) + qoff;
  const bf16* k = static_cast<const bf16*>(a.k) + koff;
  const bf16* v = static_cast<const bf16*>(a.v) + koff;
  const bool seg = a.qseg != nullptr;
  const int* qseg = seg ? a.qseg + (long long)b * Tq : nullptr;
  const int* kvseg = seg ? a.kvseg + (long long)b * Tk : nullptr;

  // the owner's side: thread (orow, kq) takes keys owner_key(kq, .) of
  // rows lr = 16 p + orow of this block's run of R rows
  const int orow = tid >> 3, kq = tid & 7;
  const int nrows = min(R, kBQ - rank * R);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  int myq[2] = {0, 0};
  if (seg)
    for (int p = 0; p < 2; ++p)
      myq[p] = __ldg(qseg + min(q0 + rank * R + 16 * p + orow, Tq - 1));

  int qlo = 0, qhi = 0;
  if (seg) warp_id_range(qseg, q0, nqr, lane, qlo, qhi);
  const int n_kt = key_tiles(a, q0, nqr);
  auto next_live = [&](int kt) {
    if (seg) {
      for (; kt < n_kt; ++kt) {
        int klo, khi;
        warp_id_range(kvseg, kt * kBK, min(kBK, Tk - kt * kBK), lane, klo,
                      khi);
        if (!(qhi < klo || qlo > khi)) break;
      }
    }
    return kt;
  };
  // a place in the order of the steps: the next step is O(ot) if o, else
  // sub-step `sub` of S(st)
  struct Cur {
    int st, ot, sub;
    bool o;
  };
  auto valid = [&](const Cur& c) { return c.o ? c.ot < n_kt : c.st < n_kt; };
  auto advance = [&](Cur& c) {
    if (!c.o) {
      if (++c.sub < nper) return;
      c.sub = 0;
      const int x = c.st;
      c.st = next_live(x + 1);
      c.o = !(x == c.ot && c.st < n_kt);   // after S(t0), S(t1) if any
    } else {
      c.ot = next_live(c.ot + 1);
      c.o = c.st >= n_kt;
    }
  };
  // S: K's slice rank + C sub (after Q's where Q is not held); O: V's
  // output slice
  auto load_step = [&](int slot, const Cur& c) {
    bf16* dst = ring + slot * slot_elems;
    if (!c.o) {
      const int col = (rank + C * c.sub) * kWO;
      if (!kHold) {
        load_slice_async(dst, q + col, q0, Tq, D);
        dst += kWChunk;
      }
      load_slice_async(dst, k + col, c.st * kBK, Tk, D);
    } else if (has_out) {
      load_slice_async(dst, v + co * kWO, c.ot * kBK, Tk, D);
    }
  };

  if constexpr (kHold) {   // Q's slice, staged in the partial buffers
    load_slice_async(reinterpret_cast<bf16*>(part), q + rank * kWO, q0, Tq,
                     D);
  }
  cp_async_commit();
  const int t0 = next_live(0);
  Cur cur{t0, t0, 0, false}, ahead = cur;
  for (int st = 0; st < kWRing - 1; ++st) {
    if (valid(ahead)) {
      load_step(st, ahead);
      advance(ahead);
    }
    cp_async_commit();
  }
  const uint32_t aoff = a_off<kWO>(lane), boff = b_off<kWO>(lane);
  uint32_t qf[kWO / 16][4];
  if constexpr (kHold) {
    cp_async_wait<kWRing - 1>();   // Q has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kWO / 16; ++kk)
      ldsm_x4(frag_at<kWO>(smem_u32(part), warp * 16, aoff, kk), qf[kk]);
  }
  // where this thread's two rows of a partial tile go: the owner's first
  // buffer, slot `rank`
  float* to_owner[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + g + 8 * i, own = row / R;
    to_owner[i] = cluster.map_shared_rank(part, own) +
                  (rank * R + row - own * R) * kWPS + 2 * t;
  }
  cluster.sync();   // every block runs; the staged Q is in registers

  // The owner step of the tile of ordinal i at key tile kt: wait for its
  // partials, sum them in rank order, mask and scale, update the rows'
  // running max and sum, and write P (bfloat16) and the rescaling factors
  // into buffer i % 2 of every block; then arrive at barrier 2.
  auto owner_step = [&](int i, int kt) {
    const int k0 = kt * kBK, buf = i & 1;
    cluster_wait();   // barrier 1: every partial of this tile has landed
    for (int p = 0; p < 2 && 16 * p < R; ++p) {
      const int lr = 16 * p + orow, row = rank * R + lr, qp = q0 + row;
      const bool live = lr < nrows;   // the same for a row's 8 lanes
      float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (live) sum_partials(x, part + buf * part_elems, C, R, lr, kq);
      float mc = kNegInf;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        const int kp = k0 + owner_key(kq, e);
        bool ok = live && kp < Tk;
        if (a.causal) ok = ok && qp + off >= kp;
        if (seg) ok = ok && myq[p] == __ldg(kvseg + min(kp, Tk - 1));
        x[e] = ok ? x[e] * a.scale : kNegInf;
        mc = fmaxf(mc, x[e]);
      }
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 1));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 2));
      mc = fmaxf(mc, __shfl_xor_sync(0xffffffffu, mc, 4));
      const float mn = fmaxf(m[p], mc);
      const float alpha = exp_tc(m[p] - mn);
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        // a row with nothing visible so far has m == s == -1e30: its
        // dead entries must not count as exp(0) = 1
        x[e] = x[e] > kNegInf * 0.5f ? exp_tc(x[e] - mn) : 0.f;
        rs += x[e];
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      rs += __shfl_xor_sync(0xffffffffu, rs, 4);
      l[p] = l[p] * alpha + rs;
      m[p] = mn;
      if (live) {
        push_row_bf16(cluster, Pb + buf * kBQ * kBK, C, row, kq, x);
        if (kq == 0)
          for (int c = 0; c < C; ++c)
            cluster.map_shared_rank(alpha_b + buf * kBQ, c)[row] = alpha;
      }
    }
    cluster_arrive();   // barrier 2: P and the factors are written
  };

  float s[8][4], o[16][4];
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;

  int ns = 0, no = 0, nown = 0;   // S steps, O steps, owner steps done
  int slot = 0;
  while (valid(cur)) {
    if (valid(ahead)) {   // into the slot the previous step used
      load_step((slot + kWRing - 1) % kWRing, ahead);
      advance(ahead);
    }
    cp_async_commit();
    cp_async_wait<kWRing - 1>();   // this step's slices have landed
    __syncthreads();
    const uint32_t sl = smem_u32(ring + slot * slot_elems);
    if (!cur.o) {
      if (cur.sub == 0) {
        if (nown < ns) owner_step(nown++, cur.ot);   // the previous tile's
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      }
      slice_scores<kHold>(s, qf, sl, kHold ? sl : sl + 2 * kWChunk, warp,
                          aoff, boff);
      if (cur.sub == nper - 1) {
        float* const to[2] = {to_owner[0] + (ns & 1) * part_elems,
                              to_owner[1] + (ns & 1) * part_elems};
        push_partial(s, to);
        if (ns == 0) cluster_arrive();   // barrier 1 of the first tile
        ++ns;
      }
    } else {
      if (nown == no) owner_step(nown++, cur.ot);   // no S came between
      cluster_wait();   // barrier 2: P of this tile has landed
      if (ns > no + 1) cluster_arrive();   // barrier 1 of the next tile
      const int buf = no & 1;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float al = alpha_b[buf * kBQ + warp * 16 + g + 8 * i];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          o[j][2 * i] *= al;
          o[j][2 * i + 1] *= al;
        }
      }
      // O += P . V: P as rounded by its owner, V's slice by ldmatrix.trans
      if (has_out)
        tile_times_slice(o, smem_u32(Pb + buf * kBQ * kBK), sl, warp, lane);
      ++no;
    }
    __syncthreads();   // every warp is done with this slot
    slot = (slot + 1) % kWRing;
    advance(cur);
  }
  cp_async_wait<0>();

  // the owners' denominators to every block, and lse once
  for (int p = 0; p < 2 && 16 * p < R; ++p) {
    const int lr = 16 * p + orow, row = rank * R + lr, qp = q0 + row;
    if (lr >= nrows || kq != 0) continue;
    const float den = fmaxf(l[p], 1e-30f);
    for (int c = 0; c < C; ++c) cluster.map_shared_rank(den_b, c)[row] = den;
    if (a.lse_out != nullptr && blockIdx.x < C && qp < Tq)
      a.lse_out[(long long)bh * Tq + qp] = m[p] + logf(den);
  }
  cluster.sync();   // (also: no block leaves while others write into it)
  if (!has_out) return;
  bf16* out = static_cast<bf16*>(a.out) + qoff + co * kWO;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i, qp = q0 + r;
    if (qp >= Tq) continue;
    const float den = den_b[r];
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(out + (long long)qp * D + 8 * j + 2 * t) =
          pack_bf16(o[j][2 * i] / den, o[j][2 * i + 1] / den);
  }
}

// K2, bfloat16, D > 256: dQ. Grid and clusters as K1. The steps of a key
// tile: the partial S over the block's slices of Q and K, then the partial
// dP over its slices of dO and V (each pushed to the owners as it is
// done, so the two share their registers), then K's output slice for
// dQ += dS . K. kHold as K1's (two blocks an SM).
template <bool kHold>
__global__ void __launch_bounds__(kTcThreads, kHold ? 2 : 1)
    flash_dq_wide_tc_kernel(Args a) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const WidePlan pl = wide_plan(a.D);
  const int D = a.D, C = pl.C, R = pl.R;
  const int rank = (int)cluster.block_rank();
  const int co = (blockIdx.x / C) * C + rank;
  const bool has_out = co < pl.nch;
  const int nper = (pl.nch - rank + C - 1) / C;
  const int slot_elems = (kHold ? 1 : 2) * kWChunk;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* ring = reinterpret_cast<bf16*>(smem_tc);
  // the partial S and dP of the rows it owns, [C][R][kWPS] each
  float* part_s = reinterpret_cast<float*>(ring + kWRing * slot_elems);
  float* part_p = part_s + C * R * kWPS;
  bf16* Sb = reinterpret_cast<bf16*>(part_p + C * R * kWPS);   // dS [64][64]

  const int Tq = a.Tq, Tk = a.Tk, off = Tk - Tq;
  const int bh = blockIdx.y, b = bh / a.H;
  const int qb = gridDim.z - 1 - blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = qb * kBQ, nqr = min(kBQ, Tq - q0);
  const long long qoff = (long long)bh * Tq * D, koff = (long long)bh * Tk * D;
  const bf16* q = static_cast<const bf16*>(a.q) + qoff;
  const bf16* gq = static_cast<const bf16*>(a.dout) + qoff;
  const bf16* k = static_cast<const bf16*>(a.k) + koff;
  const bf16* v = static_cast<const bf16*>(a.v) + koff;
  const bool seg = a.qseg != nullptr;
  const int* qseg = seg ? a.qseg + (long long)b * Tq : nullptr;
  const int* kvseg = seg ? a.kvseg + (long long)b * Tk : nullptr;

  // the owner's rows (as K1), with their lse, delta and ids (rows past Tq
  // read the last row's; their dQ is never written)
  const int orow = tid >> 3, kq = tid & 7;
  const int nrows = min(R, kBQ - rank * R);
  float lse[2], dl[2];
  int myq[2] = {0, 0};
  for (int p = 0; p < 2; ++p) {
    const int qp = min(q0 + rank * R + 16 * p + orow, Tq - 1);
    lse[p] = __ldg(a.lse_in + (long long)bh * Tq + qp);
    dl[p] = __ldg(a.delta + (long long)bh * Tq + qp);
    if (seg) myq[p] = __ldg(qseg + qp);
  }

  int qlo = 0, qhi = 0;
  if (seg) warp_id_range(qseg, q0, nqr, lane, qlo, qhi);
  const int n_kt = key_tiles(a, q0, nqr);
  auto next_live = [&](int kt) {
    if (seg) {
      for (; kt < n_kt; ++kt) {
        int klo, khi;
        warp_id_range(kvseg, kt * kBK, min(kBK, Tk - kt * kBK), lane, klo,
                      khi);
        if (!(qhi < klo || qlo > khi)) break;
      }
    }
    return kt;
  };
  // sub < nper: K's slice rank + C sub (after Q's where not held);
  // nper <= sub < 2 nper: V's (after dO's); sub == 2 nper: K's output slice
  const int nsub = 2 * nper + 1;
  auto load_step = [&](int slot, int tile, int sub) {
    bf16* dst = ring + slot * slot_elems;
    if (sub < 2 * nper) {
      const bool is_s = sub < nper;
      const int c = (rank + C * (is_s ? sub : sub - nper)) * kWO;
      if (!kHold) {
        load_slice_async(dst, (is_s ? q : gq) + c, q0, Tq, D);
        dst += kWChunk;
      }
      load_slice_async(dst, (is_s ? k : v) + c, tile * kBK, Tk, D);
    } else if (has_out) {
      load_slice_async(dst, k + co * kWO, tile * kBK, Tk, D);
    }
  };
  auto advance = [&](int& tile, int& sub) {
    if (++sub == nsub) {
      sub = 0;
      tile = next_live(tile + 1);
    }
  };

  if constexpr (kHold) {   // Q's and dO's slices, staged in part_s
    load_slice_async(reinterpret_cast<bf16*>(part_s), q + rank * kWO, q0, Tq,
                     D);
    load_slice_async(reinterpret_cast<bf16*>(part_s) + kWChunk,
                     gq + rank * kWO, q0, Tq, D);
  }
  cp_async_commit();
  int kt = next_live(0), sub = 0, at = kt, as = 0;
  for (int st = 0; st < kWRing - 1; ++st) {
    if (at < n_kt) {
      load_step(st, at, as);
      advance(at, as);
    }
    cp_async_commit();
  }
  const uint32_t aoff = a_off<kWO>(lane), boff = b_off<kWO>(lane);
  uint32_t qf[kWO / 16][4], gf[kWO / 16][4];
  if constexpr (kHold) {
    cp_async_wait<kWRing - 1>();   // Q and dO have landed
    __syncthreads();
    const uint32_t st = smem_u32(part_s);
#pragma unroll
    for (int kk = 0; kk < kWO / 16; ++kk) {
      ldsm_x4(frag_at<kWO>(st, warp * 16, aoff, kk), qf[kk]);
      ldsm_x4(frag_at<kWO>(st + 2 * kWChunk, warp * 16, aoff, kk), gf[kk]);
    }
  }
  float* to_owner_s[2];
  float* to_owner_p[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = warp * 16 + g + 8 * i, own = row / R;
    const int at_row = (rank * R + row - own * R) * kWPS + 2 * t;
    to_owner_s[i] = cluster.map_shared_rank(part_s, own) + at_row;
    to_owner_p[i] = cluster.map_shared_rank(part_p, own) + at_row;
  }
  cluster.sync();   // every block runs; the staged Q and dO are in registers

  float x8[8][4], dq[16][4];   // x8: S's partial, then dP's
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[j][e] = 0.f;

  int slot = 0;
  while (kt < n_kt) {
    if (at < n_kt) {
      load_step((slot + kWRing - 1) % kWRing, at, as);
      advance(at, as);
    }
    cp_async_commit();
    cp_async_wait<kWRing - 1>();
    __syncthreads();
    const uint32_t sl = smem_u32(ring + slot * slot_elems);
    if (sub < 2 * nper) {
      const bool is_s = sub < nper;
      const int i = is_s ? sub : sub - nper;
      if (i == 0) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) x8[j][e] = 0.f;
      }
      const uint32_t bt = kHold ? sl : sl + 2 * kWChunk;
      if (is_s)
        slice_scores<kHold>(x8, qf, sl, bt, warp, aoff, boff);
      else
        slice_scores<kHold>(x8, gf, sl, bt, warp, aoff, boff);
      if (i == nper - 1) {
        if (is_s)
          push_partial(x8, to_owner_s);
        else
          push_partial(x8, to_owner_p);
      }
    } else {
      const int k0 = kt * kBK;
      cluster.sync();   // every partial of this tile has landed
      for (int p = 0; p < 2 && 16 * p < R; ++p) {
        const int lr = 16 * p + orow, row = rank * R + lr, qp = q0 + row;
        if (lr >= nrows) continue;
        float sv[8], dp[8];
        sum_partials(sv, part_s, C, R, lr, kq);
        sum_partials(dp, part_p, C, R, lr, kq);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int kp = k0 + owner_key(kq, e);
          bool ok = kp < Tk;
          if (a.causal) ok = ok && qp + off >= kp;
          if (seg) ok = ok && myq[p] == __ldg(kvseg + min(kp, Tk - 1));
          const float pe = ok ? exp_tc(sv[e] * a.scale - lse[p]) : 0.f;
          sv[e] = pe * (dp[e] - dl[p]) * a.scale;
        }
        push_row_bf16(cluster, Sb, C, row, kq, sv);
      }
      cluster.sync();   // dS has landed
      // dQ += dS . K: dS as rounded by its owner, K's output slice by
      // ldmatrix.trans
      if (has_out) tile_times_slice(dq, smem_u32(Sb), sl, warp, lane);
    }
    __syncthreads();
    slot = (slot + 1) % kWRing;
    advance(kt, sub);
  }
  cp_async_wait<0>();
  // (the last remote write came before the last tile's second barrier)
  if (!has_out) return;
  bf16* dqo = static_cast<bf16*>(a.dq) + qoff + co * kWO;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qp = q0 + warp * 16 + g + 8 * i;
    if (qp >= Tq) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(dqo + (long long)qp * D + 8 * j + 2 * t) =
          pack_bf16(dq[j][2 * i], dq[j][2 * i + 1]);
  }
}

// Dynamic shared memory of the wide kernels, in bytes: the same at every D.
constexpr size_t fwd_wide_smem() {
  return sizeof(float) * ((size_t)(kBQ + kBK) * kWLD + (size_t)kBK * kWO +
                          (size_t)kBQ * kPS) +
         sizeof(int) * (kBQ + kBK);
}
constexpr size_t dq_wide_smem() {
  return sizeof(float) * ((size_t)2 * (kBQ + kBK) * kWLD +
                          (size_t)kBK * kWO + (size_t)kBQ * kPS + 2 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}
constexpr size_t dkv_wide_smem() {
  return sizeof(float) * ((size_t)2 * (kBQ + kBK) * kWLD +
                          (size_t)2 * kBQ * kWO + (size_t)2 * kBQ * kPS +
                          2 * kBQ) +
         sizeof(int) * (kBQ + kBK);
}
static_assert(dkv_wide_smem() <= 232448, "K3 wide exceeds 227 KB");

template <typename Kernel>
cudaError_t launch(Kernel kern, dim3 grid, size_t smem, cudaStream_t s,
                   const Args& a, int threads = kThreads) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<grid, threads, smem, s>>>(a);
  return cudaGetLastError();
}

// A launch in clusters of `csize` blocks along x (cudaLaunchKernelEx);
// every error, the attribute's included, goes back to the caller.
template <typename Kernel>
cudaError_t launch_cluster(Kernel kern, dim3 grid, int csize, size_t smem,
                           cudaStream_t s, const Args& a) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kTcThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = csize;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

enum Which { kFwd = 0, kDq = 1, kDkv = 2 };

template <typename T, int D>
cudaError_t run(int which, const Args& a, int BH, cudaStream_t s) {
  const int nq = (a.Tq + kBQ - 1) / kBQ, nk = (a.Tk + kBK - 1) / kBK;
  if constexpr (std::is_same<T, bf16>::value) {
    // bfloat16 K1-K3 on the tensor cores, grid (batch*head, tile, half)
    constexpr int NH = D / out_cols<D>();
    if (which == kFwd)
      return launch(flash_fwd_tc_kernel<D>, dim3(BH, nq, NH),
                    fwd_tc_smem<D>(), s, a, kTcThreads);
    if (which == kDq)
      return launch(flash_dq_tc_kernel<D>, dim3(BH, nq, NH), dq_tc_smem<D>(),
                    s, a, kTcThreads);
    return launch(flash_dkv_tc_kernel<D>, dim3(BH, nk, NH), dkv_tc_smem<D>(),
                  s, a, kTcThreads);
  } else {
    const int nq32 = (a.Tq + f32_bq<D>() - 1) / f32_bq<D>();
    if (which == kFwd)
      return launch(flash_fwd_kernel<D>, dim3(nq, BH), fwd_smem<D>(), s, a);
    if (which == kDq)
      return launch(flash_dq_kernel<D>, dim3(nq32, BH), dq_smem<D>(), s, a);
    return launch(flash_dkv_kernel<D>, dim3(nk, BH), dkv_smem<D>(), s, a);
  }
}

// The wide-head route: bfloat16 K1 and K2 on the tensor cores, grid
// (G * C, batch*head, q tile) in clusters of C; the rest on the CUDA
// cores, grid (tile, batch*head, D / kWO).
template <typename T>
cudaError_t run_wide(int which, const Args& a, int BH, cudaStream_t s) {
  const int nq = (a.Tq + kBQ - 1) / kBQ, nk = (a.Tk + kBK - 1) / kBK;
  const int nz = a.D / kWO;
  if constexpr (std::is_same<T, bf16>::value) {
    if (which != kDkv) {
      const WidePlan p = wide_plan(a.D);
      const dim3 grid(p.G * p.C, BH, nq);
      const size_t smem = wide_tc_smem(which == kFwd, a.D);
      if (which == kFwd)
        return p.hold ? launch_cluster(flash_fwd_wide_tc_kernel<true>, grid,
                                       p.C, smem, s, a)
                      : launch_cluster(flash_fwd_wide_tc_kernel<false>, grid,
                                       p.C, smem, s, a);
      return p.hold ? launch_cluster(flash_dq_wide_tc_kernel<true>, grid, p.C,
                                     smem, s, a)
                    : launch_cluster(flash_dq_wide_tc_kernel<false>, grid,
                                     p.C, smem, s, a);
    }
  } else {
    if (which == kFwd)
      return launch(flash_fwd_wide_kernel<T>, dim3(nq, BH, nz),
                    fwd_wide_smem(), s, a);
    if (which == kDq)
      return launch(flash_dq_wide_kernel<T>, dim3(nq, BH, nz),
                    dq_wide_smem(), s, a);
  }
  return launch(flash_dkv_wide_kernel<T>, dim3(nk, BH, nz), dkv_wide_smem(),
                s, a);
}

template <typename T>
cudaError_t run_d(int which, int D, const Args& a, int BH, cudaStream_t s) {
  if (D > 256)
    return D % kWO == 0 ? run_wide<T>(which, a, BH, s)
                        : cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return run<T, 32>(which, a, BH, s);
    case 64:
      return run<T, 64>(which, a, BH, s);
    case 128:
      return run<T, 128>(which, a, BH, s);
    case 256:
      return run<T, 256>(which, a, BH, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int run_checked(int which, int is_bf16, int D, Args a, int BH,
                void* stream) {
  a.D = D;
  if (BH < 1 || BH > 65535 || a.H < 1 || BH % a.H != 0 || a.Tq < 1 ||
      a.Tk < 1 || a.Tq > 65535 * kBQ || a.Tk > 65535 * kBK)
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

// Dynamic shared memory, in bytes, of the kernel that `which` (0 forward,
// 1 dQ, 2 dK/dV) launches for the type and head dim (any multiple of 128
// above 256 takes the wide-head route); 0 for another D.
int ptt_flash_smem_bytes(int which, int is_bf16, int D) {
  if (D > 256) {
    if (D % kWO != 0) return 0;
    if (is_bf16 && which != kDkv) return (int)wide_tc_smem(which == kFwd, D);
    if (which == kFwd) return (int)fwd_wide_smem();
    if (which == kDq) return (int)dq_wide_smem();
    return (int)dkv_wide_smem();
  }
  auto pick = [&](auto d) -> size_t {
    constexpr int kD = decltype(d)::value;
    if (which == kFwd) return is_bf16 ? fwd_tc_smem<kD>() : fwd_smem<kD>();
    if (which == kDq) return is_bf16 ? dq_tc_smem<kD>() : dq_smem<kD>();
    return is_bf16 ? dkv_tc_smem<kD>() : dkv_smem<kD>();
  };
  switch (D) {
    case 32:
      return (int)pick(std::integral_constant<int, 32>());
    case 64:
      return (int)pick(std::integral_constant<int, 64>());
    case 128:
      return (int)pick(std::integral_constant<int, 128>());
    case 256:
      return (int)pick(std::integral_constant<int, 256>());
    default:
      return 0;
  }
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
