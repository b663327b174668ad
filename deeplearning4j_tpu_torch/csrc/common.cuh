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

// Asynchronous global -> shared copies (cp.async, sm_80 and later): the
// copy bypasses registers, and the issuing thread goes on until it
// waits for its committed groups. A src_bytes of 0 fills the
// destination with zeros and reads nothing (the masked edge of a
// tile); `src` must still be a valid address.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most `Pending` committed groups are still in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

// The shared memory a block can use on an H100 (227 KB); above 48 KB a
// kernel takes it only as dynamic shared memory, after
// cudaFuncSetAttribute raises its cap.
constexpr int kMaxSmemBytes = 232448;

// Raise `kernel`'s dynamic shared-memory cap to `bytes` and ask for the
// largest shared-memory carveout, once per device (the attribute is a
// property of the function in the device's context); returns the
// cudaError_t of the calls (0 on success). `done` is the caller's
// per-kernel bit mask of devices already set.
template <typename Kernel>
inline int allow_dynamic_smem(Kernel kernel, int bytes, unsigned* done) {
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  const unsigned bit = dev < 32 ? (1u << dev) : 0u;
  if (bit != 0 && (__atomic_load_n(done, __ATOMIC_ACQUIRE) & bit)) return 0;
  rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc != 0) return rc;
  rc = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (rc != 0) return rc;
  __atomic_fetch_or(done, bit, __ATOMIC_ACQ_REL);
  return 0;
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

// out[i] = act(sum_z partial[z][i] * scale[ch] + shift[ch] [+ res[i]]),
// with ch = (i / inner) % n_ch: NCHW conv output (inner = oh*ow, n_ch =
// o) or a row-major matmul output (inner = 1, n_ch = n). scale may be
// null (1), and so may shift (0): the backward kernels' plain sums; res
// (the matmul's pre-activation residual, output layout) may be null.
template <typename T>
__global__ void splitk_finish_kernel(const float* __restrict__ partial,
                                     int splits, long long total,
                                     const float* __restrict__ scale,
                                     const float* __restrict__ shift,
                                     long long inner, int n_ch, int act,
                                     T* __restrict__ out,
                                     const T* __restrict__ res) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    float z = 0.0f;
    for (int s = 0; s < splits; ++s) z += partial[(long long)s * total + i];
    const int ch = (int)((i / inner) % n_ch);
    const float sc = scale != nullptr ? scale[ch] : 1.0f;
    const float sf = shift != nullptr ? shift[ch] : 0.0f;
    z = z * sc + sf;
    if (res != nullptr) z += to_f32(res[i]);
    out[i] = from_f32<T>(apply_act(z, act));
  }
}

template <typename T>
int launch_splitk_finish(const float* partial, int splits, long long total,
                         const float* scale, const float* shift,
                         long long inner, int n_ch, int act, T* out,
                         cudaStream_t stream, const T* res = nullptr) {
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 8 * kSmCount * 8) blocks = 8 * kSmCount * 8;
  splitk_finish_kernel<T><<<(unsigned)blocks, threads, 0, stream>>>(
      partial, splits, total, scale, shift, inner, n_ch, act, out, res);
  return (int)cudaGetLastError();
}

}  // namespace

// ---------------------------------------------------------------------------
// LSTM (csrc/lstm_cell.cu, csrc/lstm_seq.cu)
// ---------------------------------------------------------------------------
//
// Layouts are the JAX package's: xproj [.., b, 4n] (= x @ W + b, gate
// column blocks i, f, o, g of n each), h / c [b, n], RW [n, 4n]. A block
// owns kUnits hidden units (a "slice"): the 4 * kUnits gate columns
// {g * n + unit} of RW. Its 256 threads are kRowGroups row groups by
// kUnits units; a thread owns one unit and RPT batch rows (rg, rg + 32,
// ...) of a tile of 32 * RPT rows, and accumulates all four gates of its
// unit, so the gate nonlinearities and the c / h update run in its
// registers: the [b, 4n] pre-activation never reaches device memory.
namespace lstm {

constexpr int kUnits = 8;
constexpr int kCols = 4 * kUnits;              // gate columns of a slice
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kUnits;  // 32
constexpr int kKTile = 32;                     // h_{t-1} @ RW depth slice
constexpr int kHStride = kKTile + 1;           // h tile row stride (floats)
constexpr int kJTile = 32;                     // dz @ RW^T depth slice
constexpr int kJStride = kJTile + 4;           // 16-byte aligned rows

__host__ __device__ inline int slices(int n) {
  return (n + kUnits - 1) / kUnits;
}

// rows a thread owns: 1 for b <= 32, 2 for b <= 64, 4 for b <= 128, else 8
inline int rows_per_thread(int b) {
  return b <= 32 ? 1 : b <= 64 ? 2 : b <= 128 ? 4 : 8;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// The slice's gate columns of RW, unit-major and gate-minor
// (dst[k][u][g] = RW[k][g * n + unit0 + u], zero past n), for depth rows
// [k0, k0 + rows): a thread's four gates are then one 16-byte load.
__device__ __forceinline__ void load_rw_cols(const float* __restrict__ rw,
                                             int n, int unit0, int k0,
                                             int rows, float* dst) {
  for (int idx = threadIdx.x; idx < rows * kCols; idx += kThreads) {
    const int kk = idx / kCols, c = idx % kCols;
    const int g = c / kUnits, u = c % kUnits;  // 8 threads: 8 adjacent units
    const int gk = k0 + kk, gu = unit0 + u;
    dst[kk * kCols + u * 4 + g] =
        (gk < n && gu < n) ? __ldg(rw + (size_t)gk * 4 * n + g * n + gu)
                           : 0.0f;
  }
}

// acc[i][g] = sum_k hprev[row0 + rg + 32 i][k] * RW[k][g * n + unit0 + u]
// for this thread's unit u and rows. hprev is read through L2 (__ldcg):
// in the sequence kernels other blocks wrote it in the previous step.
// rw_res: the slice's columns resident in shared memory (all n depth
// rows, load_rw_cols layout), or null to stream them from RW through
// rw_stage one depth slice at a time.
template <int RPT>
__device__ __forceinline__ void gate_preacts(
    const float* hprev, int b, int n, int row0,
    const float* __restrict__ rw, int unit0, const float* rw_res,
    float* rw_stage, float* h_s, float acc[RPT][4]) {
  const int u = threadIdx.x % kUnits, rg = threadIdx.x / kUnits;
  constexpr int br = kRowGroups * RPT;
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  for (int k0 = 0; k0 < n; k0 += kKTile) {
    const int kt = min(kKTile, n - k0);
    __syncthreads();  // the previous slice's readers are done
    for (int idx = threadIdx.x; idx < br * kKTile; idx += kThreads) {
      const int r = idx / kKTile, kk = idx % kKTile;
      const int gr = row0 + r, gk = k0 + kk;
      h_s[r * kHStride + kk] =
          (gr < b && gk < n) ? __ldcg(hprev + (size_t)gr * n + gk) : 0.0f;
    }
    if (rw_res == nullptr) load_rw_cols(rw, n, unit0, k0, kt, rw_stage);
    __syncthreads();
    const float* w = rw_res != nullptr ? rw_res + (size_t)k0 * kCols
                                       : rw_stage;
#pragma unroll 4
    for (int kk = 0; kk < kt; ++kk) {
      const float4 wv =
          *reinterpret_cast<const float4*>(w + kk * kCols + u * 4);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float hv = h_s[(rg + kRowGroups * i) * kHStride + kk];
        acc[i][0] = fmaf(hv, wv.x, acc[i][0]);
        acc[i][1] = fmaf(hv, wv.y, acc[i][1]);
        acc[i][2] = fmaf(hv, wv.z, acc[i][2]);
        acc[i][3] = fmaf(hv, wv.w, acc[i][3]);
      }
    }
  }
}

// Shared memory (floats) of gate_preacts' h tile at RPT rows a thread.
inline int h_tile_floats(int rpt) { return kRowGroups * rpt * kHStride; }

}  // namespace lstm

}  // namespace dl4j
