// Fused decode-attention step for Hopper (sm_90a): one KV-cache tick's
// softmax(q . K^T * scale + bias) . V for G query positions (G = 1 on the
// decode tick, gamma + 1 on a speculative verify forward), over a float32,
// a bfloat16 or an int8 cache.
//
// Replaces paddle_tpu/fusion/decode_attention.py:_decode_step_kernel (the
// Pallas TPU kernel, driven by _decode_pallas). It computes what that
// kernel computes: scores, max and sum in float32, the output cast to q's
// type once. The JAX package sends a G > 1 window and an int8 cache
// (dequantized to q's type before the call, :218-221) through its XLA
// composite; here both run in this kernel. A bfloat16 cache (the
// encoder-decoder's cross-attention keys, projected by a bfloat16 fc) is
// read as the TPU kernel reads it: each element widened to float32. It does not copy the TPU
// kernel's blocking: that kernel pads heads to 8 and positions to 128 for
// the Mosaic tiling and runs its grid in order; here nothing is padded and
// the cache is split across blocks.
//
// Bound: memory. One call reads K and V once (2 * R * nh * T * dh bytes
// times 4 for float32, 2 for bfloat16, 1 for int8, plus one float32 scale
// a time block)
// and does about 4 * G flops per cache element, far below the card's
// balance point for float32 math at any verify width, so the least time is
// the cache bytes over the memory rate: a G-wide window costs the bytes of
// one position. What the design does about it:
//
// - Split. The grid is (row * head, split, row tile): each block takes one
//   chunk of `chunk` positions of one (row, head), so a decode step with
//   few rows and heads still fills the card (`chunk_len` picks the chunk,
//   the one place it is chosen, from R * nh, T and dh alone, so neither G
//   nor the cache type changes it: the largest power of two up to 256
//   positions whose float32 K and V fit 64 KB, halved while the grid has
//   fewer than two blocks an SM, down to 16: smaller chunks were slower at
//   the NMT shape, where the partials are 512 wide).
// - Rows. A block scores up to kRowsPerBlock query rows from the chunk it
//   stages once; a third grid dimension takes further tiles of rows. Every
//   row runs the same instructions whatever G is, in the same order, so a
//   row of a G-wide launch is bit-equal to a G = 1 launch with that row's
//   q and bias (speculative verify reproduces the plain tick's attention).
// - Loads. Each block issues every K, V and bias byte of its chunk with
//   cp.async before it uses the first one (16-byte copies where the rows
//   and the cache are 16-byte aligned, 4-byte copies otherwise, and plain
//   loads for an int8 cache whose rows are not 4-byte multiples), K and the
//   bias rows as one group and V as the next. It computes the scores from
//   K in shared memory while V is still arriving, so the two sweeps of the
//   cache overlap instead of following one another.
// - int8. The int8 payload crosses HBM, a quarter of the float32 bytes,
//   with one float32 scale per time block of bt positions ([R, nh, T / bt],
//   `quantize_kv_time_blocks`). An element is dequantized where it is used,
//   from shared memory, as float(k) * scale rounded to q's type (the JAX
//   package dequantizes to q's dtype); the math after that is float32.
// - Partials. Each block writes, per query row, (o_s[dh], m_s, l_s) in
//   float32 to a scratch of [R * nh, n_split, G, dh + 2] floats that the
//   caller allocates: m_s the chunk's largest score, l_s = sum
//   exp(s - m_s), o_s = sum exp(s - m_s) V. A second small kernel,
//   launched after it on the same stream, merges them per (row, head,
//   query row): m = max m_s, w_s = exp(m_s - m), o = sum w_s o_s /
//   sum w_s l_s, cast to q's type once. A chunk whose positions are all
//   masked (bias -1e9) has m_s ~ -1e9 and gets weight exp(m_s - m) = 0
//   beside a visible chunk; a row masked everywhere has every m_s equal and
//   gives the plain version's uniform average.
//
// Scores live per chunk, so T is limited only by the grid: at most 65535
// chunks (T up to 65535 * chunk, over 16M positions at dh <= 32 and about
// 1M at dh = 512) and 65535 tiles of query rows. Head dims 1 to 512.
//
// Layouts (the wrapper makes them so): q, out [R, nh, G, dh] contiguous;
// k, v [R, nh, T, dh] contiguous float32, bfloat16 or int8 (each on its
// own); an int8 cache's
// scales [R, nh, n_scales] contiguous float32 (T % n_scales == 0); bias
// float32 addressed as bias[r * row_stride + h * head_stride + g *
// g_stride + t] (head stride 0 when one mask serves every head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;                 // cache rows in flight per warp
constexpr int kMaxHeadDim = 512;           // NJ = dh / 32 <= 16 values a lane
constexpr int kMaxChunk = 256;             // positions per block, at most
constexpr int kMinChunk = 16;              // ... at least, unless T is less
constexpr int kMaxChunkBytes = 64 * 1024;  // float32 K and V of one chunk
constexpr int kBlocksPerSm = 2;            // the grid the chunk aims for
constexpr int kMaxSplits = 65535;          // gridDim.y
constexpr int kRowsPerBlock = 8;           // query rows a block scores
constexpr int kMaxRowTiles = 65535;        // gridDim.z
constexpr int kMergeThreads = 128;
constexpr int kMergeDims = kMaxHeadDim / kMergeThreads;   // dims a thread

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
}

// Programmatic dependent launch (sm_90): the split kernel lets the merge
// launch while it runs; the merge waits here until the split kernel has
// completed and its writes are visible. Without a programmatic
// dependency, wait returns at once (stream order already holds).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions through `red` (kWarps floats); every thread gets
// the result.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  return r;
}

__device__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = 0.f;
#pragma unroll
  for (int i = 0; i < kWarps; ++i) r += red[i];
  return r;
}


// A cache element as float32: a float32 cache as it is, a bfloat16 one
// widened exactly; an int8 one dequantized as float(k) * scale, rounded to
// q's type first.
template <typename TQ>
__device__ __forceinline__ float kv_at(const float* p, int i, float) {
  return p[i];
}
template <typename TQ>
__device__ __forceinline__ float kv_at(const __nv_bfloat16* p, int i, float) {
  return __bfloat162float(p[i]);
}
template <typename TQ>
__device__ __forceinline__ float kv_at(const int8_t* p, int i, float sc) {
  return to_f32<TQ>(from_f32<TQ>(static_cast<float>(p[i]) * sc));
}

// Copies `bytes` from global to shared memory: with cp.async in 16-byte
// pieces (mode 16) or 4-byte pieces (mode 4), else with plain loads (mode
// 1, visible after the next barrier).
__device__ __forceinline__ void stage(void* dst, const void* src, int bytes,
                                      int mode) {
  char* d = static_cast<char*>(dst);
  const char* s = static_cast<const char*>(src);
  if (mode == 16) {
    for (int e = threadIdx.x; e < bytes / 16; e += kThreads)
      cp_async16(smem_u32(d + 16 * e), s + 16 * e);
  } else if (mode == 4) {
    for (int e = threadIdx.x; e < bytes / 4; e += kThreads)
      cp_async4(smem_u32(d + 4 * e), s + 4 * e);
  } else {
    for (int e = threadIdx.x; e < bytes; e += kThreads) d[e] = s[e];
  }
}

__host__ __device__ constexpr size_t align16(size_t b) {
  return (b + 15) & ~static_cast<size_t>(15);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const float* k_scale;   // [R * nh, n_kscale], or null for a float32 K
  const float* v_scale;
  int k_bt, v_bt;         // positions a scale covers
  int n_kscale, n_vscale;
  const float* bias;
  void* out;
  float* part;
  int rows_heads, n_split, nh, G, T, dh, chunk;
  long long brs, bhs, bgs;
  float scale;
  int kmode, vmode;       // stage() modes
};

// One chunk of one (row, head) for up to kRowsPerBlock query rows: each
// row's partial (o_s, m_s, l_s). NJ >= ceil(dh / 32): head dims per lane,
// a compile-time bound so q and the context sums stay in registers. A warp
// walks cache rows with its 32 lanes on neighbouring head dims, kUnroll
// rows at a time. Shared memory: K [chunk][dh], V [chunk][dh] (each in its
// cache's type), scores [gt][chunk], bias [gt][chunk], the K and V scales
// of each position [chunk] each, and the cross-warp sums [kWarps][dh].
template <typename TQ, typename TK, typename TV, int NJ>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  __shared__ float m_s[kRowsPerBlock], l_s[kRowsPerBlock];
  const int dh = a.dh, chunk = a.chunk, T = a.T, G = a.G;
  const int g0 = blockIdx.z * kRowsPerBlock;
  const int gt = min(kRowsPerBlock, G - g0);     // query rows of this block
  const size_t kb = align16(sizeof(TK) * chunk * dh);
  const size_t vb = align16(sizeof(TV) * chunk * dh);
  TK* Ks = reinterpret_cast<TK*>(smem);
  TV* Vs = reinterpret_cast<TV*>(smem + kb);
  float* sc = reinterpret_cast<float*>(smem + kb + vb);
  float* bs = sc + gt * chunk;
  float* kss = bs + gt * chunk;
  float* vss = kss + chunk;
  float* partial = vss + chunk;

  const int bh = blockIdx.x;   // row * nh + head
  const int row = bh / a.nh;
  const int head = bh - row * a.nh;
  const int t0 = blockIdx.y * chunk;
  const int n = min(chunk, T - t0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // every byte of the chunk in flight at once: K and the bias rows, then V
  const long long at = ((long long)bh * T + t0) * dh;
  stage(Ks, static_cast<const TK*>(a.k) + at, (int)sizeof(TK) * n * dh,
        a.kmode);
  const float* bp = a.bias + row * a.brs + head * a.bhs + t0;
  for (int g = 0; g < gt; ++g)
    for (int e = threadIdx.x; e < n; e += kThreads)
      cp_async4(smem_u32(bs + g * chunk + e), bp + (g0 + g) * a.bgs + e);
  cp_async_commit();
  stage(Vs, static_cast<const TV*>(a.v) + at, (int)sizeof(TV) * n * dh,
        a.vmode);
  cp_async_commit();
  launch_dependents();
  // each position's time-block scale (int8 caches)
  if (a.k_scale != nullptr)
    for (int e = threadIdx.x; e < n; e += kThreads)
      kss[e] = a.k_scale[(long long)bh * a.n_kscale + (t0 + e) / a.k_bt];
  if (a.v_scale != nullptr)
    for (int e = threadIdx.x; e < n; e += kThreads)
      vss[e] = a.v_scale[(long long)bh * a.n_vscale + (t0 + e) / a.v_bt];
  cp_async_wait<1>();   // K and the bias of this thread have landed
  __syncthreads();

  // scores sc[g][t] = q_g . K[t] * scale + bias[g][t], while V arrives
  for (int g = 0; g < gt; ++g) {
    const TQ* qp = static_cast<const TQ*>(a.q) +
                   ((long long)bh * G + g0 + g) * dh;
    float qr[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      qr[j] = d < dh ? to_f32(qp[d]) : 0.f;
    }
    float* sg = sc + g * chunk;
    const float* bg = bs + g * chunk;
    for (int r0 = warp * kUnroll; r0 < n; r0 += kWarps * kUnroll) {
      float acc[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = r0 + u;
        float s = 0.f;
        if (t < n) {
          const TK* kr = Ks + t * dh;
          const float ks = a.k_scale != nullptr ? kss[t] : 1.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int d = lane + 32 * j;
            if (d < dh) s += qr[j] * kv_at<TQ>(kr, d, ks);
          }
        }
        acc[u] = s;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float s = warp_sum(acc[u]);
        const int t = r0 + u;
        if (lane == 0 && t < n) sg[t] = s * a.scale + bg[t];
      }
    }
  }
  __syncthreads();

  // each row's max and sum over the chunk in float32, numerators in place
  for (int g = 0; g < gt; ++g) {
    float* sg = sc + g * chunk;
    float m = -INFINITY;
    for (int t = threadIdx.x; t < n; t += kThreads) m = fmaxf(m, sg[t]);
    m = block_max(m, red);
    float l = 0.f;
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float s = sg[t];
      const float p = s > -INFINITY ? expf(s - m) : 0.f;
      sg[t] = p;
      l += p;
    }
    l = block_sum(l, red);
    if (threadIdx.x == 0) {
      m_s[g] = m;
      l_s[g] = l;
    }
  }
  cp_async_wait<0>();   // V of this thread has landed
  __syncthreads();      // ... and everyone's, with p, the V scales, m and l

  // o_s = sum_t p[t] V[t] per row, cache rows split across warps as above
  float* out0 = a.part + (((long long)bh * a.n_split + blockIdx.y) * G + g0) *
                             (dh + 2);
  for (int g = 0; g < gt; ++g) {
    const float* pg = sc + g * chunk;
    float o[NJ];
#pragma unroll
    for (int j = 0; j < NJ; ++j) o[j] = 0.f;
    for (int r0 = warp * kUnroll; r0 < n; r0 += kWarps * kUnroll) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = r0 + u;
        if (t < n) {
          const float p = pg[t];
          const TV* vr = Vs + t * dh;
          const float vs = a.v_scale != nullptr ? vss[t] : 1.f;
#pragma unroll
          for (int j = 0; j < NJ; ++j) {
            const int d = lane + 32 * j;
            if (d < dh) o[j] += p * kv_at<TQ>(vr, d, vs);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int d = lane + 32 * j;
      if (d < dh) partial[warp * dh + d] = o[j];
    }
    __syncthreads();
    float* out = out0 + (long long)g * (dh + 2);
    for (int d = threadIdx.x; d < dh; d += kThreads) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += partial[w * dh + d];
      out[d] = s;
    }
    if (threadIdx.x == 0) {
      out[dh] = m_s[g];
      out[dh + 1] = l_s[g];
    }
    __syncthreads();    // the next row reuses `partial`
  }
}

// The merge: one block per (row, head, query row), threads on head dims.
// The partials' (m_s, l_s) come into shared memory kMergeThreads at a
// time, and every thread takes the piece's max and weights from there (a
// running max across pieces, rescaled as the split kernel's chunks are,
// for more than kMergeThreads chunks).
template <typename TQ>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                    int n_split, int G, int dh) {
  __shared__ float ms_s[kMergeThreads], ls_s[kMergeThreads];
  grid_dependency_wait();   // the partials are complete
  const int bhg = blockIdx.x, tid = threadIdx.x;   // (row * nh + head) * G + g
  const int bh = bhg / G;
  const int g = bhg - bh * G;
  const int stride = dh + 2;
  const long long split_stride = (long long)G * stride;
  const float* pp = part + ((long long)bh * n_split * G + g) * stride;

  float m = -INFINITY, l = 0.f, acc[kMergeDims];
#pragma unroll
  for (int j = 0; j < kMergeDims; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += kMergeThreads) {
    const int ns = min(kMergeThreads, n_split - s0);
    __syncthreads();   // the previous piece is read
    if (tid < ns) {
      ms_s[tid] = pp[(s0 + tid) * split_stride + dh];
      ls_s[tid] = pp[(s0 + tid) * split_stride + dh + 1];
    }
    __syncthreads();
    float mp = m;
    for (int i = 0; i < ns; ++i) mp = fmaxf(mp, ms_s[i]);
    // a chunk of -inf scores only (m_s = -inf) weighs nothing
    const float alpha = m > -INFINITY ? expf(m - mp) : 0.f;
    l *= alpha;
#pragma unroll
    for (int j = 0; j < kMergeDims; ++j) acc[j] *= alpha;
#pragma unroll 4
    for (int i = 0; i < ns; ++i) {
      const float w = ms_s[i] > -INFINITY ? expf(ms_s[i] - mp) : 0.f;
      const float* o = pp + (s0 + i) * split_stride;
      l += w * ls_s[i];
#pragma unroll
      for (int j = 0; j < kMergeDims; ++j) {
        const int d = tid + kMergeThreads * j;
        if (d < dh) acc[j] += w * o[d];
      }
    }
    m = mp;
  }
  const float inv_l = 1.f / l;
#pragma unroll
  for (int j = 0; j < kMergeDims; ++j) {
    const int d = tid + kMergeThreads * j;
    if (d < dh) out[(long long)bhg * dh + d] = from_f32<TQ>(acc[j] * inv_l);
  }
}

// Shared-memory bytes of decode_split_kernel for this chunk, dh, the most
// query rows a block takes, and the cache element sizes.
size_t split_smem_bytes(int chunk, int dh, int rows, size_t kbytes,
                        size_t vbytes) {
  return align16(kbytes * chunk * dh) + align16(vbytes * chunk * dh) +
         sizeof(float) * (2 * (size_t)rows * chunk + 2 * (size_t)chunk +
                          (size_t)kWarps * dh);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return n;
}

// Positions per block: the largest power of two up to kMaxChunk whose
// float32 K and V fit kMaxChunkBytes, halved while the grid would have
// fewer than kBlocksPerSm blocks an SM (down to kMinChunk), and no more
// than T. Neither the query width nor the cache type enters.
int chunk_len(long long rows_heads, int T, int dh) {
  int c = kMaxChunk;
  while (c > kMinChunk && 8LL * c * dh > kMaxChunkBytes) c >>= 1;
  const long long want = (long long)kBlocksPerSm * sm_count();
  while (c > kMinChunk && rows_heads * ((T + c - 1) / c) < want) c >>= 1;
  return c < T ? c : T;
}

// stage() mode for a cache of `elem`-byte elements at `p`.
int copy_mode(const void* p, int dh, size_t elem) {
  const uintptr_t at = reinterpret_cast<uintptr_t>(p);
  const size_t row = elem * dh;
  if (row % 16 == 0 && at % 16 == 0) return 16;
  if (row % 4 == 0 && at % 4 == 0) return 4;
  return 1;
}

template <typename TQ, typename TK, typename TV, int NJ>
cudaError_t launch(Args a, cudaStream_t stream) {
  auto kern = decode_split_kernel<TQ, TK, TV, NJ>;
  const int rows = a.G < kRowsPerBlock ? a.G : kRowsPerBlock;
  const size_t smem =
      split_smem_bytes(a.chunk, a.dh, rows, sizeof(TK), sizeof(TV));
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  a.kmode = copy_mode(a.k, a.dh, sizeof(TK));
  a.vmode = copy_mode(a.v, a.dh, sizeof(TV));
  const int tiles = (a.G + kRowsPerBlock - 1) / kRowsPerBlock;
  kern<<<dim3(a.rows_heads, a.n_split, tiles), kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the merge, as a programmatic dependent of the split kernel: its launch
  // overlaps the split kernel's run instead of following its drain
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((long long)a.rows_heads * a.G));
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_merge_kernel<TQ>,
                         static_cast<const float*>(a.part),
                         static_cast<TQ*>(a.out), a.n_split, a.G, a.dh);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// NJ rounded up to a power of two (the lanes past dh add nothing, so a
// row's arithmetic does not depend on it)
template <typename TQ, typename TK, typename TV>
cudaError_t dispatch_nj(int dh, const Args& a, cudaStream_t s) {
  const int nj = (dh + 31) / 32;
  if (nj <= 1) return launch<TQ, TK, TV, 1>(a, s);
  if (nj <= 2) return launch<TQ, TK, TV, 2>(a, s);
  if (nj <= 4) return launch<TQ, TK, TV, 4>(a, s);
  if (nj <= 8) return launch<TQ, TK, TV, 8>(a, s);
  if (nj <= 16) return launch<TQ, TK, TV, 16>(a, s);
  return cudaErrorInvalidValue;
}

// cache type codes of the C interface
constexpr int kFloat32 = 0, kInt8 = 1, kBfloat16 = 2;

template <typename TQ, typename TK>
cudaError_t dispatch_v(int v_type, const Args& a, cudaStream_t s) {
  if (v_type == kInt8) return dispatch_nj<TQ, TK, int8_t>(a.dh, a, s);
  if (v_type == kBfloat16)
    return dispatch_nj<TQ, TK, __nv_bfloat16>(a.dh, a, s);
  return dispatch_nj<TQ, TK, float>(a.dh, a, s);
}

template <typename TQ>
cudaError_t dispatch_kv(int k_type, int v_type, const Args& a,
                        cudaStream_t s) {
  if (k_type == kInt8) return dispatch_v<TQ, int8_t>(v_type, a, s);
  if (k_type == kBfloat16) return dispatch_v<TQ, __nv_bfloat16>(v_type, a, s);
  return dispatch_v<TQ, float>(v_type, a, s);
}

}  // namespace

extern "C" {

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Positions per block of a call at this shape on the current device (the
// scratch then holds [R * nh, ceil(T / chunk), G, dh + 2] floats); -1 for
// a shape the kernel does not take, more than kMaxSplits chunks included.
int ptt_decode_attention_chunk(int R, int nh, int T, int dh) {
  if (R < 1 || nh < 1 || T < 1 || dh < 1 || dh > kMaxHeadDim ||
      (long long)R * nh > 2147483647LL)
    return -1;
  const int c = chunk_len((long long)R * nh, T, dh);
  return (T + c - 1) / c > kMaxSplits ? -1 : c;
}

// q_is_bf16: 0 for float32 q/out, 1 for bfloat16 q/out. k_type / v_type:
// 0 for a float32 cache, 2 for a bfloat16 one, 1 for an int8 one with its
// scales [R * nh, n_kscale] / [R * nh, n_vscale] (ignored otherwise).
// scratch: the partials, [R * nh, n_split, G, dh + 2] float32, n_split =
// ceil(T / chunk) for ptt_decode_attention_chunk's chunk. Launches the
// split kernel and the merge on `stream`, does not synchronize, and
// returns the first launch error (cudaError_t, 0 on success).
int ptt_decode_attention(int q_is_bf16, int k_type, int v_type,
                         const void* q, const void* k, const void* v,
                         const void* k_scale, const void* v_scale,
                         int n_kscale, int n_vscale, const void* bias,
                         void* out, void* scratch, int n_split, int R, int nh,
                         int G, int T, int dh, long long bias_row_stride,
                         long long bias_head_stride, long long bias_g_stride,
                         float scale, void* stream) {
  const int chunk = ptt_decode_attention_chunk(R, nh, T, dh);
  if (chunk < 1 || n_split != (T + chunk - 1) / chunk || G < 1 ||
      (G + kRowsPerBlock - 1) / kRowsPerBlock > kMaxRowTiles ||
      (long long)R * nh * G > 2147483647LL)
    return cudaErrorInvalidValue;
  if (k_type < kFloat32 || k_type > kBfloat16 || v_type < kFloat32 ||
      v_type > kBfloat16)
    return cudaErrorInvalidValue;
  const bool k_int8 = k_type == kInt8, v_int8 = v_type == kInt8;
  if ((k_int8 && (n_kscale < 1 || T % n_kscale != 0 || !k_scale)) ||
      (v_int8 && (n_vscale < 1 || T % n_vscale != 0 || !v_scale)))
    return cudaErrorInvalidValue;
  Args a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scale = k_int8 ? static_cast<const float*>(k_scale) : nullptr;
  a.v_scale = v_int8 ? static_cast<const float*>(v_scale) : nullptr;
  a.n_kscale = k_int8 ? n_kscale : 1;
  a.n_vscale = v_int8 ? n_vscale : 1;
  a.k_bt = T / a.n_kscale;
  a.v_bt = T / a.n_vscale;
  a.bias = static_cast<const float*>(bias);
  a.out = out;
  a.part = static_cast<float*>(scratch);
  a.rows_heads = R * nh;
  a.n_split = n_split;
  a.nh = nh;
  a.G = G;
  a.T = T;
  a.dh = dh;
  a.chunk = chunk;
  a.brs = bias_row_stride;
  a.bhs = bias_head_stride;
  a.bgs = bias_g_stride;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      q_is_bf16 ? dispatch_kv<__nv_bfloat16>(k_type, v_type, a, s)
                : dispatch_kv<float>(k_type, v_type, a, s);
  return static_cast<int>(e);
}

}  // extern "C"
