// Fused decode-attention step for Hopper (sm_90a): one KV-cache tick's
// softmax(q . K^T * scale + bias) . V for a single query position.
//
// Replaces paddle_tpu/fusion/decode_attention.py:_decode_step_kernel (the
// Pallas TPU kernel, driven by _decode_pallas). It computes what that
// kernel computes: scores, max and sum in float32, the output cast to q's
// type. It does not copy its blocking: the TPU kernel pads heads to 8 and
// positions to 128 for the Mosaic tiling and runs its grid in order; here
// every (row, head) pair is an independent block and nothing is padded.
//
// Bound: memory. One launch reads K and V once (2 * R * nh * T * dh * 4
// bytes) and does about 4 flops per cache element, far below the card's
// ~20 flops/byte balance point for float32 math, so the least time is the
// cache bytes over the memory rate. The design spends nothing beyond that
// read: each warp walks cache rows with the 32 lanes on neighbouring head
// dims (coalesced 128-byte row segments, kUnroll rows in flight per warp),
// the scores live in shared memory (T floats, so T is limited by the 227 KB
// a block may use; a larger T is refused at launch), and the context sum is
// reduced across warps in shared memory. Nothing is written but the [dh]
// output.
// Simple first: no TMA, no wgmma, one block per (row, head) pair.
//
// Layouts (the wrapper makes them so): q, out [R, nh, dh] contiguous;
// k, v [R, nh, T, dh] contiguous float32; bias float32 addressed as
// bias[r * bias_row_stride + h * bias_head_stride + t] (head stride 0 when
// one mask serves every head).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr int kMaxHeadDim = 512;   // NJ = dh / 32 <= 16 values a lane

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

// NJ = ceil(dh / 32): head dims per lane, a compile-time bound so q and
// the context sums stay in registers.
template <typename TQ, int NJ>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const TQ* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v,
                        const float* __restrict__ bias, TQ* __restrict__ out,
                        int nh, int T, int dh, long long bias_row_stride,
                        long long bias_head_stride, float scale) {
  extern __shared__ float smem[];
  float* scores = smem;        // [T]
  float* partial = smem + T;   // [kWarps][dh]
  __shared__ float red[kWarps];

  const int bh = blockIdx.x;   // row * nh + head
  const int row = bh / nh;
  const int head = bh - row * nh;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  const TQ* qp = q + (long long)bh * dh;
  const float* kp = k + (long long)bh * T * dh;
  const float* vp = v + (long long)bh * T * dh;
  const float* bp = bias + row * bias_row_stride + head * bias_head_stride;

  float qr[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const int d = lane + 32 * j;
    qr[j] = d < dh ? to_f32(qp[d]) : 0.f;
  }

  // scores[t] = q . K[t] * scale + bias[t]: warp `warp` takes rows
  // warp*kUnroll .. +kUnroll-1, then strides by kWarps*kUnroll.
  for (int t0 = warp * kUnroll; t0 < T; t0 += kWarps * kUnroll) {
    float acc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      float s = 0.f;
      if (t < T) {
        const float* kr = kp + (long long)t * dh;
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
      const int t = t0 + u;
      if (lane == 0 && t < T) scores[t] = s * scale + bp[t];
    }
  }
  __syncthreads();

  // softmax numerator in place, float32 max and sum
  float m = -INFINITY;
  for (int t = threadIdx.x; t < T; t += kThreads) m = fmaxf(m, scores[t]);
  m = block_max(m, red);
  float l = 0.f;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const float p = expf(scores[t] - m);
    scores[t] = p;
    l += p;
  }
  l = block_sum(l, red);   // its barriers also publish the p values

  // context: sum_t p[t] * V[t], rows split across warps as above
  float o[NJ];
#pragma unroll
  for (int j = 0; j < NJ; ++j) o[j] = 0.f;
  for (int t0 = warp * kUnroll; t0 < T; t0 += kWarps * kUnroll) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int t = t0 + u;
      if (t < T) {
        const float p = scores[t];
        const float* vr = vp + (long long)t * dh;
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int d = lane + 32 * j;
          if (d < dh) o[j] += p * vr[d];
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
  const float inv_l = 1.f / l;
  for (int d = threadIdx.x; d < dh; d += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += partial[w * dh + d];
    out[(long long)bh * dh + d] = from_f32<TQ>(s * inv_l);
  }
}

template <typename TQ, int NJ>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* bias, void* out, int rows_heads, int nh, int T,
                   int dh, long long bias_row_stride,
                   long long bias_head_stride, float scale, size_t smem,
                   cudaStream_t stream) {
  auto kern = decode_attention_kernel<TQ, NJ>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<rows_heads, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(bias),
      static_cast<TQ*>(out), nh, T, dh, bias_row_stride, bias_head_stride,
      scale);
  return cudaGetLastError();
}

template <typename TQ>
cudaError_t dispatch(int nj, const void* q, const void* k, const void* v,
                     const void* bias, void* out, int rows_heads, int nh,
                     int T, int dh, long long brs, long long bhs, float scale,
                     size_t smem, cudaStream_t s) {
  switch (nj) {
#define PTT_CASE(N) \
  case N:           \
    return launch<TQ, N>(q, k, v, bias, out, rows_heads, nh, T, dh, brs, bhs, \
                         scale, smem, s);
    PTT_CASE(1) PTT_CASE(2) PTT_CASE(3) PTT_CASE(4)
    PTT_CASE(5) PTT_CASE(6) PTT_CASE(7) PTT_CASE(8)
    PTT_CASE(9) PTT_CASE(10) PTT_CASE(11) PTT_CASE(12)
    PTT_CASE(13) PTT_CASE(14) PTT_CASE(15) PTT_CASE(16)
#undef PTT_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

// Shared-memory bytes a launch with this T and dh needs.
long long smem_bytes(int T, int dh) {
  return (long long)(T + kWarps * dh) * (long long)sizeof(float);
}

// The most dynamic shared memory one block may use on the current device.
int max_block_smem_bytes() {
  int dev = 0, bytes = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (cudaDeviceGetAttribute(&bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return bytes;
}

}  // namespace

extern "C" {

const char* ptt_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// q_is_bf16: 0 for float32 q/out, 1 for bfloat16 q/out. Returns the launch's
// cudaError_t (0 on success); launches on `stream` and does not synchronize.
int ptt_decode_attention(int q_is_bf16, const void* q, const void* k,
                         const void* v, const void* bias, void* out, int R,
                         int nh, int T, int dh, long long bias_row_stride,
                         long long bias_head_stride, float scale,
                         void* stream) {
  if (R < 1 || nh < 1 || T < 1 || dh < 1 || dh > kMaxHeadDim)
    return cudaErrorInvalidValue;
  const long long rows_heads = (long long)R * nh;
  if (rows_heads > 2147483647LL) return cudaErrorInvalidValue;
  const long long smem = smem_bytes(T, dh);
  if (smem > max_block_smem_bytes()) return cudaErrorInvalidValue;
  const int nj = (dh + 31) / 32;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      q_is_bf16 ? dispatch<__nv_bfloat16>(nj, q, k, v, bias, out,
                                          (int)rows_heads, nh, T, dh,
                                          bias_row_stride, bias_head_stride,
                                          scale, (size_t)smem, s)
                : dispatch<float>(nj, q, k, v, bias, out, (int)rows_heads, nh,
                                  T, dh, bias_row_stride, bias_head_stride,
                                  scale, (size_t)smem, s);
  return static_cast<int>(e);
}

}  // extern "C"
