// Shared helpers of the hand-written Hopper kernels: element-type
// conversions (f32 / bf16 / f16 in memory, f32 in registers), the
// fused epilogue nonlinearities, and the split-K plan and finish pass.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace dl4j {

// dtype codes shared with the Python wrappers (ops/_build.py DTYPE_CODES)
enum DType { kF32 = 0, kBF16 = 1, kF16 = 2 };

// epilogue codes shared with the Python wrappers (ops/conv_block.py
// EPILOGUE_CODES); numerics follow nn/activations.py
enum Act { kIdentity = 0, kRelu = 1, kLeakyRelu = 2, kTanh = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float v) {
  return __float2half(v);
}

__device__ __forceinline__ float apply_act(float z, int act) {
  switch (act) {
    case kRelu:
      return fmaxf(z, 0.0f);
    case kLeakyRelu:
      return z >= 0.0f ? z : z * 0.01f;
    case kTanh:
      return tanhf(z);
    default:
      return z;
  }
}

// Split-K. When the output has too few tiles to fill the card, the
// reduction axis (length k_len) is cut into `splits` chunks of k_chunk
// (a multiple of the kernels' 16-deep k slice), one per blockIdx.z.
// Each chunk writes its raw f32 sums to partial[z][...] (output
// layout); splitk_finish adds the chunks in order and applies the
// epilogue. The wrapper asks for the plan (kernel_splits), allocates
// the scratch and passes it in, so the kernels allocate nothing.
constexpr int kSmCount = 132;        // H100 SXM
constexpr int kTargetBlocks = 2 * kSmCount;
constexpr int kMinKPerSplit = 64;
constexpr int kMaxSplits = 32;
constexpr int kKSliceAll = 16;       // the k slice of both kernels

inline int ceil_div(long long a, long long b) { return (int)((a + b - 1) / b); }

inline int k_chunk_for(int k_len, int splits) {
  return ceil_div(ceil_div(k_len, splits), kKSliceAll) * kKSliceAll;
}

// number of k chunks (1: no split) for `tiles` output tiles
inline int plan_splits(long long tiles, int k_len) {
  if (tiles >= kTargetBlocks || k_len < 2 * kMinKPerSplit) return 1;
  int s = ceil_div(kTargetBlocks, tiles);
  const int by_depth = k_len / kMinKPerSplit;
  if (s > by_depth) s = by_depth;
  if (s > kMaxSplits) s = kMaxSplits;
  if (s < 1) s = 1;
  return ceil_div(k_len, k_chunk_for(k_len, s));
}

// The conv weight gradient is the opposite case: a tiny output (LeNet's
// first conv has 500 weights, one tile) over a huge reduction (n*oh*ow,
// 147,456 deep at batch 256). Its own plan splits that reduction until
// about two waves of blocks are in flight, each split at least
// kMinRPerSplit deep, up to kMaxDwSplits; a fixed-order finish pass adds
// the partial sums, so no atomics are needed and the result is bitwise
// the same from run to run.
constexpr int kMinRPerSplit = 128;
constexpr int kMaxDwSplits = 1024;

inline int plan_dw_splits(long long tiles, long long r_len) {
  if (tiles >= kTargetBlocks || r_len < 2 * kMinRPerSplit) return 1;
  long long s = ceil_div(kTargetBlocks, tiles);
  const long long by_depth = r_len / kMinRPerSplit;
  if (s > by_depth) s = by_depth;
  if (s > kMaxDwSplits) s = kMaxDwSplits;
  if (s < 1) s = 1;
  const long long chunk =
      (long long)ceil_div(ceil_div(r_len, s), kKSliceAll) * kKSliceAll;
  return ceil_div(r_len, chunk);
}

inline long long r_chunk_for(long long r_len, int splits) {
  return (long long)ceil_div(ceil_div(r_len, splits), kKSliceAll) *
         kKSliceAll;
}

// Internal linkage: each kernel source gets its own copy of the finish
// kernel, so the objects register no shared kernel symbol.
namespace {

// out[i] = act(sum_z partial[z][i] * scale[ch] + shift[ch]), with
// ch = (i / inner) % n_ch: NCHW conv output (inner = oh*ow, n_ch = o) or
// a row-major matmul output (inner = 1, n_ch = n). scale may be null (1),
// and so may shift (0): the backward kernels' plain sums.
template <typename T>
__global__ void splitk_finish_kernel(const float* __restrict__ partial,
                                     int splits, long long total,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ shift,
                                     long long inner, int n_ch, int act,
                                     T* __restrict__ out) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    float z = 0.0f;
    for (int s = 0; s < splits; ++s) z += partial[(long long)s * total + i];
    const int ch = (int)((i / inner) % n_ch);
    const float sc = scale != nullptr ? scale[ch] : 1.0f;
    const float sf = shift != nullptr ? shift[ch] : 0.0f;
    out[i] = from_f32<T>(apply_act(z * sc + sf, act));
  }
}

template <typename T>
int launch_splitk_finish(const float* partial, int splits, long long total,
                         const float* scale, const float* shift,
                         long long inner, int n_ch, int act, T* out,
                         cudaStream_t stream) {
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 8 * kSmCount * 8) blocks = 8 * kSmCount * 8;
  splitk_finish_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      partial, splits, total, scale, shift, inner, n_ch, act, out);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace dl4j
