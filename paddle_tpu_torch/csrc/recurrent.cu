// Whole-sequence LSTM and GRU recurrences for Hopper (sm_90a): every time
// step of one sequence batch in a single launch.
//
// Replaces paddle_tpu/fusion/recurrent.py:_lstm_seq_kernel (LSTM) and
// _gru_seq_kernel (GRU), both driven by _pallas_seq. They compute what those
// kernels compute, in float32:
//
//   LSTM  gates (i, f, c^, o) = x_t + h . w     (x [B,T,4H], w [H,4H])
//         c = sig(f) c + sig(i) tanh(c^),  h = sig(o) tanh(c)
//   GRU   r, z = sig(x_t[:, :2H] + h . w[:, :2H])            (w [H,3H])
//         c = tanh(x_t[:, 2H:] + (r h) . w[:, 2H:]),  h = z h + (1 - z) c
//
// A row whose step position (t, or T-1-t for a reversed sequence whose x the
// caller flipped) is not below its length keeps its state; the gate stash
// (i, f, c^, o) or (r, z, c), written when asked for, holds the values the
// step computed either way, as the TPU kernels' stash does.
//
// The TPU kernel walks a (batch block, t) grid in order with h and c in
// VMEM scratch and all of w resident. No SM can hold w (4 MB at H = 512),
// and blocks neither run in order nor share memory, so the design here is a
// persistent cooperative kernel: block g owns hidden units [g U, g U + U)
// for every batch row and keeps their gate columns of w in shared memory
// for the whole sequence (and their c, h in shared memory too), so the cell
// update is local. Only h crosses blocks: each step every block writes its
// units' new h into a [B, H] buffer in global memory (it stays in L2) and
// reads everyone's after one grid-wide barrier. The LSTM needs one barrier
// per step (h double-buffered); the GRU two, because its candidate product
// needs r h of units other blocks own: phase A computes r, z and publishes
// r h, a barrier, phase B the candidate and the new h, a barrier.
//
// The recurrent product of a step is a [B, H] x [H, G U] product per block
// (G = 4 or 3 gates): batch rows ride the 32 lanes of a warp, the 8 warps
// split k, h is staged through shared memory 128 columns at a time (read
// through L2 with __ldcg: other SMs wrote it during this launch), and the
// warps' partial sums are added in shared memory. Float32 FMAs on the CUDA
// cores; tensor cores (TF32 would change the results the plain version
// gives) and overlapping the staging with the math are later work.
//
// Bound on this card: at the stacked LSTM's shape (B 64, T 100, H 512) the
// recurrent products are 2 B T H 4H = 13.4 GFLOP (~0.2 ms at 67 TFLOP/s
// float32) against ~135 MB of inputs and outputs (~40 us), so operations
// bound it, with T grid barriers (2T for the GRU) as a serial floor beside.
//
// Launch: U is the smallest of 1, 2, 4, 8 with ceil(H / U) blocks no more
// than the SMs, one block on each; cudaLaunchCooperativeKernel guarantees
// they are co-resident, which the barrier needs. H larger than 8 SMs' worth,
// or a w slice beyond shared memory, is refused (cudaErrorInvalidValue).

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;                  // batch rows per tile: one a lane
constexpr int kChunk = 128;                // columns of h staged at once
constexpr int kPerWarp = kChunk / kWarps;  // of which each warp takes 16
constexpr int kLd = kChunk + 1;            // padded staged row: no conflicts
constexpr int kStage = kRows * kChunk / kThreads;  // staged values a thread

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

// Grid-wide barrier, the scheme of cooperative_groups' grid sync: block 0
// adds 0x80000000 - (nblocks - 1) and every other block 1, so each barrier
// flips the counter's top bit exactly once; a block waits for the flip.
// The fences publish the block's global writes before it arrives and order
// its later reads after everyone arrived. A wait beyond ~2^34 clocks (about
// ten seconds) means a block never arrived: the kernel traps, which the
// caller sees as a CUDA error, instead of holding the card.
__device__ __forceinline__ void grid_sync(unsigned int* arrived) {
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int add =
        blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
    __threadfence();
    const unsigned int old = atomicAdd(arrived, add);
    volatile unsigned int* flag = arrived;
    const long long start = clock64();
    while (((old ^ *flag) & 0x80000000u) == 0) {
      if (clock64() - start > (1ll << 34)) __trap();
    }
    __threadfence();
  }
  __syncthreads();
}

// One row tile of the block's recurrent product: for batch rows
// row0 .. row0 + 31 (row0 + lane for this thread) and NC columns starting at
// C0 of the block's w slice w_s ([H][LDW] in shared memory), each warp sums
// its share of k; the partial sums land in red[warp][lane][c], and the block
// synchronizes before returning so that the caller may add them up.
// src is [B, H] in global memory, written by other blocks in this launch.
template <int NC, int LDW, int C0>
__device__ __forceinline__ void row_tile_product(
    const float* src, int B, int H, int row0, const float* __restrict__ w_s,
    float* __restrict__ h_s, float* __restrict__ red) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float acc[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < H; k0 += kChunk) {
    // every load of the chunk is in flight at once, and before the
    // barrier: one L2 latency a chunk, not one a load
    float v[kStage];
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int p = threadIdx.x + i * kThreads;
      const int b = row0 + p / kChunk;
      const int k = k0 + p % kChunk;
      v[i] = (b < B && k < H) ? __ldcg(src + (size_t)b * H + k) : 0.f;
    }
    __syncthreads();  // the previous chunk's (or tile's) readers are done
#pragma unroll
    for (int i = 0; i < kStage; ++i) {
      const int p = threadIdx.x + i * kThreads;
      h_s[(p / kChunk) * kLd + p % kChunk] = v[i];
    }
    __syncthreads();
    const int kb = warp * kPerWarp;
    const int kn = min(kPerWarp, H - k0 - kb);
    for (int kk = 0; kk < kn; ++kk) {
      const float hv = h_s[lane * kLd + kb + kk];
      const float* wr = w_s + (size_t)(k0 + kb + kk) * LDW + C0;
      if constexpr (NC % 4 == 0 && LDW % 4 == 0 && C0 % 4 == 0) {
#pragma unroll
        for (int c = 0; c < NC; c += 4) {
          const float4 wv = *reinterpret_cast<const float4*>(wr + c);
          acc[c] = fmaf(hv, wv.x, acc[c]);
          acc[c + 1] = fmaf(hv, wv.y, acc[c + 1]);
          acc[c + 2] = fmaf(hv, wv.z, acc[c + 2]);
          acc[c + 3] = fmaf(hv, wv.w, acc[c + 3]);
        }
      } else {
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[c] = fmaf(hv, wr[c], acc[c]);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < NC; ++c) red[(warp * kRows + lane) * NC + c] = acc[c];
  __syncthreads();
}

// The (tile row, owned unit) pair a thread updates after a row tile's
// product: thread r * U + u takes row row0 + r and unit j0 + u; `mine` is
// false for threads beyond kRows * U and for pairs past B or H.
struct TilePair {
  int r, u, b, j;
  bool mine;
};

template <int U>
__device__ __forceinline__ TilePair tile_pair(int row0, int j0, int B,
                                              int H) {
  static_assert(kRows * U <= kThreads, "one pair a thread at most");
  TilePair q;
  q.r = threadIdx.x / U;
  q.u = threadIdx.x - q.r * U;
  q.b = row0 + q.r;
  q.j = j0 + q.u;
  q.mine = threadIdx.x < kRows * U && q.b < B && q.j < H;
  return q;
}

// The sum over warps of column c for tile row r.
template <int NC>
__device__ __forceinline__ float warp_total(const float* red, int r, int c) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += red[(w * kRows + r) * NC + c];
  return s;
}

// Load the block's gate columns of w ([H][NG * H] row-major) into w_s
// ([H][NG * U]): column g * U + u holds gate g of unit j0 + u (zeros past H).
template <int NG, int U>
__device__ void load_w_slice(const float* __restrict__ w, int H, int j0,
                             float* __restrict__ w_s) {
  constexpr int NC = NG * U;
  for (int p = threadIdx.x; p < H * NC; p += kThreads) {
    const int k = p / NC;
    const int c = p - k * NC;
    const int g = c / U;
    const int j = j0 + c - g * U;
    w_s[p] = j < H ? w[(size_t)k * NG * H + (size_t)g * H + j] : 0.f;
  }
}

template <int U>
size_t lstm_smem_bytes(int B, int H) {
  return ((size_t)H * 4 * U + kRows * kLd + kWarps * kRows * 4 * U +
          2 * (size_t)B * U) *
         sizeof(float);
}

template <int U>
__global__ void __launch_bounds__(kThreads)
lstm_seq_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ h0, const float* __restrict__ c0,
                const int* __restrict__ seqlen, int B, int T, int H,
                int reverse, float* __restrict__ hs, float* __restrict__ cs,
                float* __restrict__ stash, float* hbuf,
                unsigned int* arrived) {
  constexpr int NC = 4 * U;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                          // [H][NC]
  float* h_s = w_s + (size_t)H * NC;          // [kRows][kLd]
  float* red = h_s + kRows * kLd;             // [kWarps][kRows][NC]
  float* h_own = red + kWarps * kRows * NC;   // [B][U]
  float* c_own = h_own + (size_t)B * U;       // [B][U]
  const int j0 = blockIdx.x * U;
  const size_t bh = (size_t)B * H;

  load_w_slice<4, U>(w, H, j0, w_s);
  for (int p = threadIdx.x; p < B * U; p += kThreads) {
    const int b = p / U;
    const int j = j0 + p - b * U;
    if (j < H) {
      const float hv = h0[(size_t)b * H + j];
      h_own[p] = hv;
      c_own[p] = c0[(size_t)b * H + j];
      hbuf[(size_t)b * H + j] = hv;
    }
  }
  grid_sync(arrived);

  for (int t = 0; t < T; ++t) {
    const float* hcur = hbuf + (t & 1) * bh;
    float* hnxt = hbuf + ((t + 1) & 1) * bh;
    const int tpos = reverse ? T - 1 - t : t;
    for (int row0 = 0; row0 < B; row0 += kRows) {
      const TilePair q = tile_pair<U>(row0, j0, B, H);
      const size_t xo = ((size_t)q.b * T + t) * 4 * H + q.j;
      float xg[4];
      if (q.mine) {  // in flight while the product runs
#pragma unroll
        for (int g = 0; g < 4; ++g) xg[g] = x[xo + (size_t)g * H];
      }
      row_tile_product<NC, NC, 0>(hcur, B, H, row0, w_s, h_s, red);
      if (q.mine) {
        const int r = q.r, u = q.u, b = q.b, j = q.j;
        const float ig = sigmoid_f(xg[0] + warp_total<NC>(red, r, u));
        const float fg = sigmoid_f(xg[1] + warp_total<NC>(red, r, U + u));
        const float gg = tanhf(xg[2] + warp_total<NC>(red, r, 2 * U + u));
        const float og = sigmoid_f(xg[3] + warp_total<NC>(red, r, 3 * U + u));
        const int o = b * U + u;
        float cn = fg * c_own[o] + ig * gg;
        float hn = og * tanhf(cn);
        if (seqlen[b] <= tpos) {
          cn = c_own[o];
          hn = h_own[o];
        }
        c_own[o] = cn;
        h_own[o] = hn;
        const size_t so = ((size_t)b * T + t) * H + j;
        hs[so] = hn;
        cs[so] = cn;
        if (stash != nullptr) {
          stash[xo] = ig;
          stash[xo + H] = fg;
          stash[xo + 2 * H] = gg;
          stash[xo + 3 * H] = og;
        }
        hnxt[(size_t)b * H + j] = hn;
      }
    }
    grid_sync(arrived);
  }
}

template <int U>
size_t gru_smem_bytes(int B, int H) {
  return ((size_t)H * 3 * U + kRows * kLd + kWarps * kRows * 2 * U +
          3 * (size_t)B * U) *
         sizeof(float);
}

template <int U>
__global__ void __launch_bounds__(kThreads)
gru_seq_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const float* __restrict__ h0, const int* __restrict__ seqlen,
               int B, int T, int H, int reverse, float* __restrict__ hs,
               float* __restrict__ stash, float* buf,
               unsigned int* arrived) {
  constexpr int NC = 3 * U;
  extern __shared__ __align__(16) float smem[];
  float* w_s = smem;                          // [H][NC]: r | z | c columns
  float* h_s = w_s + (size_t)H * NC;          // [kRows][kLd]
  float* red = h_s + kRows * kLd;             // [kWarps][kRows][2U]
  float* h_own = red + kWarps * kRows * 2 * U;  // [B][U]
  float* r_own = h_own + (size_t)B * U;       // [B][U]
  float* z_own = r_own + (size_t)B * U;       // [B][U]
  const int j0 = blockIdx.x * U;
  // buf[0]: h, read in phase A and written in phase B of each step (all
  // reads precede the middle barrier, all writes follow it); buf[1]: r h.
  float* hbuf = buf;
  float* rhbuf = buf + (size_t)B * H;

  load_w_slice<3, U>(w, H, j0, w_s);
  for (int p = threadIdx.x; p < B * U; p += kThreads) {
    const int b = p / U;
    const int j = j0 + p - b * U;
    if (j < H) {
      h_own[p] = h0[(size_t)b * H + j];
      hbuf[(size_t)b * H + j] = h_own[p];
    }
  }
  grid_sync(arrived);

  for (int t = 0; t < T; ++t) {
    const int tpos = reverse ? T - 1 - t : t;
    // phase A: r, z of the owned units; publish r h
    for (int row0 = 0; row0 < B; row0 += kRows) {
      const TilePair q = tile_pair<U>(row0, j0, B, H);
      const size_t xo = ((size_t)q.b * T + t) * 3 * H + q.j;
      float xr = 0.f, xz = 0.f;
      if (q.mine) {  // in flight while the product runs
        xr = x[xo];
        xz = x[xo + H];
      }
      row_tile_product<2 * U, NC, 0>(hbuf, B, H, row0, w_s, h_s, red);
      if (q.mine) {
        const int r = q.r, u = q.u, b = q.b, j = q.j;
        const float rg = sigmoid_f(xr + warp_total<2 * U>(red, r, u));
        const float zg = sigmoid_f(xz + warp_total<2 * U>(red, r, U + u));
        const int o = b * U + u;
        r_own[o] = rg;
        z_own[o] = zg;
        rhbuf[(size_t)b * H + j] = rg * h_own[o];
      }
    }
    grid_sync(arrived);
    // phase B: the candidate over every unit's r h, then the new h
    for (int row0 = 0; row0 < B; row0 += kRows) {
      const TilePair q = tile_pair<U>(row0, j0, B, H);
      const size_t xo = ((size_t)q.b * T + t) * 3 * H + q.j;
      const float xc = q.mine ? x[xo + 2 * H] : 0.f;
      row_tile_product<U, NC, 2 * U>(rhbuf, B, H, row0, w_s, h_s, red);
      if (q.mine) {
        const int r = q.r, u = q.u, b = q.b, j = q.j;
        const float cg = tanhf(xc + warp_total<U>(red, r, u));
        const int o = b * U + u;
        const float zg = z_own[o];
        const float hp = h_own[o];
        float hn = zg * hp + (1.f - zg) * cg;
        if (seqlen[b] <= tpos) hn = hp;
        h_own[o] = hn;
        hs[((size_t)b * T + t) * H + j] = hn;
        if (stash != nullptr) {
          stash[xo] = r_own[o];
          stash[xo + H] = zg;
          stash[xo + 2 * H] = cg;
        }
        hbuf[(size_t)b * H + j] = hn;
      }
    }
    grid_sync(arrived);
  }
}

// Cooperative launch of `kern` on `grid` blocks, one on each SM at most.
template <typename K>
cudaError_t coop_launch(K kern, int grid, size_t smem, void** args,
                        cudaStream_t stream) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  int coop = 0, sms = 0, smem_max = 0;
  cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  if (!coop) return cudaErrorNotSupported;
  if (grid > sms || smem > (size_t)smem_max) return cudaErrorInvalidValue;
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem);
  if (e != cudaSuccess) return e;
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                    smem);
  if (e != cudaSuccess) return e;
  if (per_sm < 1) return cudaErrorInvalidValue;
  e = cudaLaunchCooperativeKernel((const void*)kern, dim3(grid),
                                  dim3(kThreads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// Units per block: the smallest of 1, 2, 4, 8 that needs no more blocks
// than the device has SMs; 0 when none does.
int units_per_block(int H) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int u = 1; u <= 8; u *= 2)
    if ((H + u - 1) / u <= sms) return u;
  return 0;
}

template <int U>
cudaError_t launch_lstm(const float* x, const float* w, const float* h0,
                        const float* c0, const int* seqlen, int B, int T,
                        int H, int reverse, float* hs, float* cs,
                        float* stash, float* hbuf, unsigned int* arrived,
                        cudaStream_t s) {
  void* args[] = {&x, &w, &h0, &c0, &seqlen, &B, &T, &H, &reverse,
                  &hs, &cs, &stash, &hbuf, &arrived};
  return coop_launch(lstm_seq_kernel<U>, (H + U - 1) / U,
                     lstm_smem_bytes<U>(B, H), args, s);
}

template <int U>
cudaError_t launch_gru(const float* x, const float* w, const float* h0,
                       const int* seqlen, int B, int T, int H, int reverse,
                       float* hs, float* stash, float* buf,
                       unsigned int* arrived, cudaStream_t s) {
  void* args[] = {&x, &w, &h0, &seqlen, &B, &T, &H, &reverse,
                  &hs, &stash, &buf, &arrived};
  return coop_launch(gru_seq_kernel<U>, (H + U - 1) / U,
                     gru_smem_bytes<U>(B, H), args, s);
}

}  // namespace

extern "C" {

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// x [B,T,4H], w [H,4H], h0/c0 [B,H] float32 contiguous; seqlen [B] int32;
// hs, cs [B,T,H]; stash [B,T,4H] or null; hbuf [2,B,H] float32 scratch;
// arrived: one zeroed unsigned int. Returns the launch's cudaError_t;
// launches on `stream` and does not synchronize.
int ptt_lstm_seq(const void* x, const void* w, const void* h0,
                 const void* c0, const void* seqlen, int B, int T, int H,
                 int reverse, void* hs, void* cs, void* stash, void* hbuf,
                 void* arrived, void* stream) {
  if (B < 1 || T < 1 || H < 1) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* h0f = static_cast<const float*>(h0);
  const float* c0f = static_cast<const float*>(c0);
  const int* sl = static_cast<const int*>(seqlen);
  float* hsf = static_cast<float*>(hs);
  float* csf = static_cast<float*>(cs);
  float* stf = static_cast<float*>(stash);
  float* hb = static_cast<float*>(hbuf);
  unsigned int* ar = static_cast<unsigned int*>(arrived);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (units_per_block(H)) {
    case 1: e = launch_lstm<1>(xf, wf, h0f, c0f, sl, B, T, H, reverse, hsf, csf, stf, hb, ar, s); break;
    case 2: e = launch_lstm<2>(xf, wf, h0f, c0f, sl, B, T, H, reverse, hsf, csf, stf, hb, ar, s); break;
    case 4: e = launch_lstm<4>(xf, wf, h0f, c0f, sl, B, T, H, reverse, hsf, csf, stf, hb, ar, s); break;
    case 8: e = launch_lstm<8>(xf, wf, h0f, c0f, sl, B, T, H, reverse, hsf, csf, stf, hb, ar, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

// x [B,T,3H], w [H,3H], h0 [B,H] float32 contiguous; seqlen [B] int32;
// hs [B,T,H]; stash [B,T,3H] or null; buf [2,B,H] float32 scratch;
// arrived: one zeroed unsigned int.
int ptt_gru_seq(const void* x, const void* w, const void* h0,
                const void* seqlen, int B, int T, int H, int reverse,
                void* hs, void* stash, void* buf, void* arrived,
                void* stream) {
  if (B < 1 || T < 1 || H < 1) return cudaErrorInvalidValue;
  const float* xf = static_cast<const float*>(x);
  const float* wf = static_cast<const float*>(w);
  const float* h0f = static_cast<const float*>(h0);
  const int* sl = static_cast<const int*>(seqlen);
  float* hsf = static_cast<float*>(hs);
  float* stf = static_cast<float*>(stash);
  float* bf = static_cast<float*>(buf);
  unsigned int* ar = static_cast<unsigned int*>(arrived);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (units_per_block(H)) {
    case 1: e = launch_gru<1>(xf, wf, h0f, sl, B, T, H, reverse, hsf, stf, bf, ar, s); break;
    case 2: e = launch_gru<2>(xf, wf, h0f, sl, B, T, H, reverse, hsf, stf, bf, ar, s); break;
    case 4: e = launch_gru<4>(xf, wf, h0f, sl, B, T, H, reverse, hsf, stf, bf, ar, s); break;
    case 8: e = launch_gru<8>(xf, wf, h0f, sl, B, T, H, reverse, hsf, stf, bf, ar, s); break;
    default: e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}

}  // extern "C"
