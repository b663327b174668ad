// Fused dense layer: out = act(x @ w + b [+ r]).
//
// Replaces deeplearning4j_tpu/ops/matmul_block.py::_matmul_kernel (:53)
// and, with the residual operand, ::_matmul_res_kernel (:59), both
// reached through _matmul_block_call from matmul_block.
//
// Layout: x [m, k], w [k, n] (the layer's W as stored, y = x @ W + b;
// not nn.Linear's [out, in]), b f32 [n], r and out [m, n]. x, w, r and
// out share one element type (f32, bf16 or f16); the sum is f32 in
// registers and is cast once on the store, as the TPU kernel does. The
// residual r (nullable: the residual-free path is the same code with a
// uniform branch) is added to the f32 sum after the bias and before the
// activation, in the TPU kernel's order: act((x @ w + b) + r).
//
// What bounds it on an H100: at serving batch sizes the product is
// skinny. AlexNet's 9216 -> 4096 layer at batch 64 does 4.8 GFLOP but
// must read the 151 MB weight matrix: 45 us of HBM traffic at 3.35 TB/s
// against 72 us of FP32 FMA at 67 TFLOP/s, so it sits near the ridge,
// and at batch 32 (LeNet's 800 -> 512 at the largest bucket) bytes bound
// it outright. TF32 tensor cores would not hold f32 parity, so FP32 FMA
// it is.
//
// Design: the TPU kernel holds all of K per tile in VMEM; Hopper's
// 227 KB of shared memory cannot hold a 9216 x 64 slice, so here each
// block owns a 64 x 64 output tile and walks K in slices of 16, staging
// an x slice and a w slice in shared memory per step (both loads
// coalesced along their contiguous axis). Each of the 256 threads keeps
// a 4 x 4 block of f32 accumulators in registers. Ragged m, n and k
// edges are masked while staging and storing, so any shape is taken
// (no divisibility gate like matmul_block_ok). The bias add and the
// activation run on the accumulators before the single store.
//
// A skinny product has few 64 x 64 tiles (AlexNet's 9216 -> 4096 layer
// at batch 64: 64 tiles for 132 SMs, each streaming a 9216-deep slab
// alone). Then K is split over blockIdx.z until about two waves of
// blocks are in flight (common.cuh plan_splits); each split writes its
// f32 sums to a scratch and splitk_finish adds them in a fixed order
// and applies the bias and activation, so the result is deterministic.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kMBlock = 64;
constexpr int kNBlock = 64;
constexpr int kKSlice = 16;
constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    matmul_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        const float* __restrict__ bias,
                        const T* __restrict__ res, T* __restrict__ out,
                        float* __restrict__ partial, int m, int k_len, int n,
                        int k_chunk, int act) {
  __shared__ float x_s[kKSlice][kMBlock + 4];
  __shared__ float w_s[kKSlice][kNBlock];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // column group of this thread's outputs
  const int ty = tid / 16;  // row group of this thread's outputs
  const int m0 = blockIdx.y * kMBlock;
  const int n0 = blockIdx.x * kNBlock;
  // this block's k chunk (all of k unless split-K)
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(k_len, k_lo + k_chunk);

  // x stager: k column xk, rows xm, xm+16, ... (row-major x: k contiguous)
  const int xk = tid % kKSlice;
  const int xm = tid / kKSlice;
  // w stager: n column wn, k rows wk, wk+4, ... (row-major w: n contiguous)
  const int wn = tid % kNBlock;
  const int wk = tid / kNBlock;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kKSlice) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = m0 + xm + 16 * i;
      const int k = k0 + xk;
      float v = 0.0f;
      if (row < m && k < k_hi) v = dl4j::to_f32(x[(size_t)row * k_len + k]);
      x_s[xk][xm + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = wk + 4 * i;
      const int k = k0 + kk;
      const int col = n0 + wn;
      float v = 0.0f;
      if (k < k_hi && col < n) v = dl4j::to_f32(w[(size_t)k * n + col]);
      w_s[kk][wn] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKSlice; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = x_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = w_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= n) continue;
      const size_t idx = (size_t)row * n + col;
      if (partial != nullptr) {
        partial[(size_t)blockIdx.z * m * n + idx] = acc[i][j];
      } else {
        float z = acc[i][j] + bias[col];
        if (res != nullptr) z += dl4j::to_f32(res[idx]);
        out[idx] = dl4j::from_f32<T>(dl4j::apply_act(z, act));
      }
    }
  }
}

long long tiles(int m, int n) {
  return (long long)dl4j::ceil_div(m, kMBlock) * dl4j::ceil_div(n, kNBlock);
}

template <typename T>
int launch(const void* x, const void* w, const float* bias, const void* res,
           void* out, float* partial, int m, int k, int n, int act,
           int splits, cudaStream_t stream) {
  const long long m_blocks = dl4j::ceil_div(m, kMBlock);
  const long long n_blocks = dl4j::ceil_div(n, kNBlock);
  if (m_blocks > 65535 || n_blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int k_chunk = k;
  int z = 1;
  if (splits > 1) {
    if (partial == nullptr || k <= 0) return (int)cudaErrorInvalidValue;
    k_chunk = dl4j::k_chunk_for(k, splits);
    z = dl4j::ceil_div(k, k_chunk);
    if (z > splits) return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)n_blocks, (unsigned)m_blocks, (unsigned)z);
  matmul_block_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), bias,
      static_cast<const T*>(res), static_cast<T*>(out),
      z > 1 ? partial : nullptr, m, k, n, k_chunk, act);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || z == 1) return rc;
  return dl4j::launch_splitk_finish<T>(partial, z, (long long)m * n, nullptr,
                                       bias, 1, n, act, static_cast<T*>(out),
                                       stream, static_cast<const T*>(res));
}

}  // namespace

// The number of k chunks for an [m, k] x [k, n] product (1: no split);
// the wrapper allocates an f32 scratch of splits * m * n when it is > 1.
extern "C" int dl4j_matmul_block_splits(int m, int k, int n) {
  if (m <= 0 || n <= 0) return 1;
  return dl4j::plan_splits(tiles(m, n), k);
}

// Returns the cudaError_t of the launch (0 on success). Shapes are
// validated by the Python wrapper (ops/matmul_block.py); `res` is the
// [m, n] residual (null: none); `partial` is the split-K scratch (null
// when splits is 1).
extern "C" int dl4j_matmul_block(const void* x, const void* w,
                                 const void* bias, const void* res,
                                 void* out, void* partial, int dtype, int m,
                                 int k, int n, int act, int splits,
                                 void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const float* b = static_cast<const float*>(bias);
  float* ws = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dl4j::kF32:
      return launch<float>(x, w, b, res, out, ws, m, k, n, act, splits, st);
    case dl4j::kBF16:
      return launch<__nv_bfloat16>(x, w, b, res, out, ws, m, k, n, act,
                                   splits, st);
    case dl4j::kF16:
      return launch<__half>(x, w, b, res, out, ws, m, k, n, act, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
