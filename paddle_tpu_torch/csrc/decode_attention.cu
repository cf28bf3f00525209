// Fused decode-attention step for Hopper (sm_90a): one KV-cache tick's
// softmax(q . K^T * scale + bias) . V for a single query position.
//
// Replaces paddle_tpu/fusion/decode_attention.py:_decode_step_kernel (the
// Pallas TPU kernel, driven by _decode_pallas). It computes what that
// kernel computes: scores, max and sum in float32, the output cast to q's
// type once. It does not copy its blocking: the TPU kernel pads heads to 8
// and positions to 128 for the Mosaic tiling and runs its grid in order;
// here nothing is padded and the cache is split across blocks.
//
// Bound: memory. One call reads K and V once (2 * R * nh * T * dh * 4
// bytes) and does about 4 flops per cache element, far below the card's
// ~20 flops/byte balance point for float32 math, so the least time is the
// cache bytes over the memory rate. What the design does about it:
//
// - Split. The grid is (row * head, split): each block takes one chunk of
//   `chunk` positions of one (row, head), so a decode step with few rows
//   and heads still fills the card (`chunk_len` picks the chunk, the one
//   place it is chosen: the largest power of two up to 256 positions whose
//   K and V fit 64 KB, halved while the grid has fewer than two blocks an
//   SM, down to 16: smaller chunks were slower at the NMT shape, where
//   the partials are 512 wide).
// - Loads. Each block issues every K, V and bias byte of its chunk with
//   cp.async before it uses the first one (16-byte copies where dh % 4 ==
//   0 and K and V are 16-byte aligned, 4-byte copies otherwise), K and the
//   bias as one group and V as the next. It computes the scores from K in
//   shared memory while V is still arriving, so the two sweeps of the
//   cache overlap instead of following one another.
// - Partials. Each block writes (o_s[dh], m_s, l_s) in float32 to a
//   scratch of [R * nh, n_split, dh + 2] floats that the caller allocates:
//   m_s the chunk's largest score, l_s = sum exp(s - m_s), o_s = sum
//   exp(s - m_s) V. A second small kernel, launched after it on the same
//   stream, merges them: m = max m_s, w_s = exp(m_s - m),
//   o = sum w_s o_s / sum w_s l_s, cast to q's type once. A chunk whose
//   positions are all masked (bias -1e9) has m_s ~ -1e9 and gets weight
//   exp(m_s - m) = 0 beside a visible chunk; a row masked everywhere has
//   every m_s equal and gives the plain version's uniform average.
//
// Scores live per chunk, so T is limited only by the grid: at most 65535
// chunks (T up to 65535 * chunk, over 16M positions at dh <= 32 and about
// 1M at dh = 512). Head dims 1 to 512.
//
// Layouts (the wrapper makes them so): q, out [R, nh, dh] contiguous;
// k, v [R, nh, T, dh] contiguous float32; bias float32 addressed as
// bias[r * bias_row_stride + h * bias_head_stride + t] (head stride 0 when
// one mask serves every head).

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
constexpr int kMaxChunkBytes = 64 * 1024;  // K and V of one chunk
constexpr int kBlocksPerSm = 2;            // the grid the chunk aims for
constexpr int kMaxSplits = 65535;          // gridDim.y
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

// Copies n floats from global to shared memory with cp.async: 16 bytes a
// copy when vec16 (n a multiple of 4, both ends 16-byte aligned), else 4.
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           int n, bool vec16) {
  if (vec16) {
    for (int e = threadIdx.x; e < n / 4; e += kThreads)
      cp_async16(smem_u32(dst + 4 * e), src + 4 * e);
  } else {
    for (int e = threadIdx.x; e < n; e += kThreads)
      cp_async4(smem_u32(dst + e), src + e);
  }
}

// One chunk of one (row, head): its partial (o_s, m_s, l_s). NJ =
// ceil(dh / 32): head dims per lane, a compile-time bound so q and the
// context sums stay in registers. A warp walks cache rows with its 32
// lanes on neighbouring head dims, kUnroll rows at a time.
// Shared memory: K [max(chunk, kWarps)][dh] (reused for the cross-warp
// sums once the scores are done), V [chunk][dh], scores [chunk], bias
// [chunk].
template <typename TQ, int NJ>
__global__ void __launch_bounds__(kThreads)
decode_split_kernel(const TQ* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ bias, float* __restrict__ part,
                    int nh, int T, int dh, int chunk,
                    long long bias_row_stride, long long bias_head_stride,
                    float scale, int vec16) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[kWarps];
  float* Ks = smem;
  float* Vs = Ks + max(chunk, kWarps) * dh;
  float* sc = Vs + chunk * dh;
  float* bs = sc + chunk;

  const int bh = blockIdx.x;   // row * nh + head
  const int row = bh / nh;
  const int head = bh - row * nh;
  const int t0 = blockIdx.y * chunk;
  const int n = min(chunk, T - t0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  // every byte of the chunk in flight at once: K and bias, then V
  const long long at = ((long long)bh * T + t0) * dh;
  copy_async(Ks, k + at, n * dh, vec16 != 0);
  const float* bp = bias + row * bias_row_stride + head * bias_head_stride;
  for (int e = threadIdx.x; e < n; e += kThreads)
    cp_async4(smem_u32(bs + e), bp + t0 + e);
  cp_async_commit();
  copy_async(Vs, v + at, n * dh, vec16 != 0);
  cp_async_commit();
  launch_dependents();

  const TQ* qp = q + (long long)bh * dh;
  float qr[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < dh ? to_f32(qp[d]) : 0.f;
  }
  cp_async_wait<1>();   // K and the bias of this thread have landed
  __syncthreads();

  // scores sc[t] = q . K[t] * scale + bias[t], while V arrives
  for (int r0 = warp * kUnroll; r0 < n; r0 += kWarps * kUnroll) {
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = r0 + u;
      float s = 0.f;
      if (t < n) {
        const float* kr = Ks + t * dh;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          if (d < dh) s += qr[j] * kr[d];
        }
      }
      acc[u] = s;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float s = warp_sum(acc[u]);
      const int t = r0 + u;
      if (lane == 0 && t < n) sc[t] = s * scale + bs[t];
    }
  }
  __syncthreads();

  // the chunk's max and sum in float32, the numerators in place
  float m = -INFINITY;
  for (int t = threadIdx.x; t < n; t += kThreads) m = fmaxf(m, sc[t]);
  m = block_max(m, red);
  float l = 0.f;
  for (int t = threadIdx.x; t < n; t += kThreads) {
    const float s = sc[t];
    const float p = s > -INFINITY ? expf(s - m) : 0.f;
    sc[t] = p;
    l += p;
  }
  cp_async_wait<0>();       // V of this thread has landed
  l = block_sum(l, red);   // its barriers publish p and V

  // o_s = sum_t p[t] V[t], rows split across warps as above
  float o[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[j] = 0.f;
  for (int r0 = warp * kUnroll; r0 < n; r0 += kWarps * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = r0 + u;
      if (t < n) {
        const float p = sc[t];
        const float* vr = Vs + t * dh;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          if (d < dh) o[j] += p * vr[d];
        }
      }
    }
  }
  float* partial = Ks;   // [kWarps][dh]; K is no longer read
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = lane + 32 * j;
    if (d < dh) partial[warp * dh + d] = o[j];
  }
  __syncthreads();
  float* out = part + ((long long)bh * gridDim.y + blockIdx.y) * (dh + 2);
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w * dh + d];
    out[d] = s;
  }
  if (threadIdx.x == 0) {
    out[dh] = m;
    out[dh + 1] = l;
  }
}

// The merge: one block per (row, head), threads on head dims. The
// partials' (m_s, l_s) come into shared memory kMergeThreads at a time,
// and every thread takes the piece's max and weights from there (a
// running max across pieces, rescaled as the split kernel's chunks are,
// for more than kMergeThreads chunks).
template <typename TQ>
__global__ void __launch_bounds__(kMergeThreads)
decode_merge_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                    int n_split, int dh) {
  __shared__ float ms_s[kMergeThreads], ls_s[kMergeThreads];
  grid_dependency_wait();   // the partials are complete
  const int bh = blockIdx.x, tid = threadIdx.x;
  const int stride = dh + 2;
  const float* pp = part + (long long)bh * n_split * stride;

  float m = -INFINITY, l = 0.f, acc[kMergeDims];
#pragma unroll
  for (int j = 0; j < kMergeDims; ++j) acc[j] = 0.f;
  for (int s0 = 0; s0 < n_split; s0 += kMergeThreads) {
    const int ns = min(kMergeThreads, n_split - s0);
    __syncthreads();   // the previous piece is read
    if (tid < ns) {
      ms_s[tid] = pp[(long long)(s0 + tid) * stride + dh];
      ls_s[tid] = pp[(long long)(s0 + tid) * stride + dh + 1];
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
      const float* o = pp + (long long)(s0 + i) * stride;
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
    if (d < dh) out[(long long)bh * dh + d] = from_f32<TQ>(acc[j] * inv_l);
  }
}

// Shared-memory bytes of decode_split_kernel for this chunk and dh.
size_t split_smem_bytes(int chunk, int dh) {
  const int kr = chunk > kWarps ? chunk : kWarps;
  return sizeof(float) * ((size_t)(kr + chunk) * dh + 2 * (size_t)chunk);
}

int sm_count() {
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) !=
      cudaSuccess)
    return 0;
  return n;
}

// Positions per block: the largest power of two up to kMaxChunk whose K
// and V fit kMaxChunkBytes, halved while the grid would have fewer than
// kBlocksPerSm blocks an SM (down to kMinChunk), and no more than T.
int chunk_len(long long rows_heads, int T, int dh) {
  int c = kMaxChunk;
  while (c > kMinChunk && 8LL * c * dh > kMaxChunkBytes) c >>= 1;
  const long long want = (long long)kBlocksPerSm * sm_count();
  while (c > kMinChunk && rows_heads * ((T + c - 1) / c) < want) c >>= 1;
  return c < T ? c : T;
}

template <typename TQ, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, float* part, int rows_heads,
                   int n_split, int nh, int T, int dh, int chunk,
                   long long brs, long long bhs, float scale,
                   cudaStream_t stream) {
  auto kern = decode_split_kernel<TQ, NJ>;
  const size_t smem = split_smem_bytes(chunk, dh);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const bool vec16 = dh % 4 == 0 && reinterpret_cast<uintptr_t>(k) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(v) % 16 == 0;
  kern<<<dim3(rows_heads, n_split), kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias), part,
      nh, T, dh, chunk, brs, bhs, scale, vec16 ? 1 : 0);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  // the merge, as a programmatic dependent of the split kernel: its launch
  // overlaps the split kernel's run instead of following its drain
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(rows_heads);
  cfg.blockDim = dim3(kMergeThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, decode_merge_kernel<TQ>,
                         static_cast<const float*>(part),
                         static_cast<TQ*>(out), n_split, dh);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch(int nj, const void* q, const void* k, const void* v,
                     const void* bias, void* out, float* part, int rows_heads,
                     int n_split, int nh, int T, int dh, int chunk,
                     long long brs, long long bhs, float scale,
                     cudaStream_t s) {
  switch (nj) {
#define PTT_CASE(N)                                                        \
  case N:                                                                  \
    return launch<TQ, N>(q, k, v, bias, out, part, rows_heads, n_split, nh, \
                         T, dh, chunk, brs, bhs, scale, s);
    PTT_CASE(1) PTT_CASE(2) PTT_CASE(3) PTT_CASE(4)
    PTT_CASE(5) PTT_CASE(6) PTT_CASE(7) PTT_CASE(8)
    PTT_CASE(9) PTT_CASE(10) PTT_CASE(11) PTT_CASE(12)
    PTT_CASE(13) PTT_CASE(14) PTT_CASE(15) PTT_CASE(16)
#undef PTT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Positions per block of a call at this shape on the current device (the
// scratch then holds [R * nh, ceil(T / chunk), dh + 2] floats); -1 for a
// shape the kernel does not take, more than kMaxSplits chunks included.
int ptt_decode_attention_chunk(int R, int nh, int T, int dh) {
  if (R < 1 || nh < 1 || T < 1 || dh < 1 || dh > kMaxHeadDim ||
      (long long)R * nh > 2147483647LL)
    return -1;
  const int c = chunk_len((long long)R * nh, T, dh);
  return (T + c - 1) / c > kMaxSplits ? -1 : c;
}

// q_is_bf16: 0 for float32 q/out, 1 for bfloat16 q/out. scratch: the
// partials, [R * nh, n_split, dh + 2] float32, n_split = ceil(T / chunk)
// for ptt_decode_attention_chunk's chunk. Launches the split kernel and
// the merge on `stream`, does not synchronize, and returns the first
// launch error (cudaError_t, 0 on success).
int ptt_decode_attention(int q_is_bf16, const void* q, const void* k,
                         const void* v, const void* bias, void* out,
                         void* scratch, int n_split, int R, int nh, int T,
                         int dh, long long bias_row_stride,
                         long long bias_head_stride, float scale,
                         void* stream) {
  const int chunk = ptt_decode_attention_chunk(R, nh, T, dh);
  if (chunk < 1 || n_split != (T + chunk - 1) / chunk)
    return cudaErrorInvalidValue;
  const int rows_heads = R * nh;
  const int nj = (dh + 31) / 32;
  float* part = static_cast<float*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      q_is_bf16
          ? dispatch<__nv_bfloat16>(nj, q, k, v, bias, out, part, rows_heads,
                                    n_split, nh, T, dh, chunk,
                                    bias_row_stride, bias_head_stride, scale,
                                    s)
          : dispatch<float>(nj, q, k, v, bias, out, part, rows_heads,
                            n_split, nh, T, dh, chunk, bias_row_stride,
                            bias_head_stride, scale, s);
  return static_cast<int>(e);
}

}  // extern "C"
