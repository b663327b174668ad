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
// activation, in the TPU kernel's order: act((x @ w + b) + r). f32
// stays FP32 FMA on both routes: TF32 tensor cores would not hold f32
// parity.
//
// Two routes, picked by the wrapper from the shape alone
// (ops/matmul_block.py matmul_route) and passed in as `route`:
//
// - tiled (kRouteTiled): products whose 128 x 192 grid is short of a
//   wave on 132 SMs: LeNet's and AlexNet's dense layers, KV-cache
//   sampling. They are skinny: AlexNet's 9216 -> 4096 layer at batch 64
//   does 4.8 GFLOP but must read the 151 MB weight matrix (45 us of HBM
//   traffic at 3.35 TB/s against 72 us of FP32 FMA at 67 TFLOP/s), and
//   at LeNet's buckets bytes bound it outright. Each block owns a
//   64 x 64 output tile and walks K in slices of 16 staged in shared
//   memory (the TPU kernel holds all of K in VMEM; 227 KB cannot hold a
//   9216 x 64 slice); 256 threads keep 4 x 4 f32 accumulators. With few
//   tiles, K is split over blockIdx.z until about two waves of blocks
//   are in flight (common.cuh plan_splits); each split writes its f32
//   sums to a scratch and splitk_finish adds them in a fixed order and
//   applies the epilogue, so the result is deterministic.
//
// - wide (kRouteWide): products whose 128 x 192 grid fills the card,
//   the transformer's (m 8192, k 3072, n 768 with the residual: 38.7
//   GFLOP over 160 MB, so FP32 FMA bounds it at 0.58 ms; the input
//   projection at k 256). The tiled kernel runs there at a third of
//   the FMA peak: its 4 x 4 tile issues 8 scalar shared loads per 16
//   FMAs, nothing overlaps the staging, and a 64 x 64 tile re-reads
//   each operand from L2 often. Here a block owns a 128 x 192 tile with
//   256 threads of 8 x 12 f32 accumulators, each thread's rows two
//   groups of 4, 64 apart, and its columns three such groups, so every
//   operand fragment is one float4 shared load (x is stored k-major,
//   transposed while it is staged; a warp's x loads are broadcasts and
//   its w loads conflict-free): 5 shared loads per 96 FMAs. A ring of
//   4 stages of 16-deep k slices (83 KB of dynamic shared memory) is
//   filled with cp.async (16-byte copies of w where n is a multiple of
//   4 and the pointers are 16-byte aligned, else 4-byte; 4-byte copies
//   of x, which land transposed), so three slices load while one
//   computes, with one barrier a slice. The accumulators take 167
//   registers, so one block an SM: at the transformer's shapes 256
//   tiles make 1.94 waves on 132 SMs, where a 128 x 128 tile at two
//   blocks an SM made 1.45 (the FFN2 product took 0.98 ms that way
//   against 0.89 on an NVIDIA H100 80GB HBM3, chip_smoke.py). Ragged
//   m, n and k are masked (zero-filled copies, masked stores), so any
//   shape is taken. The epilogue runs on the accumulators and stores 16
//   bytes at a time where it can. bf16 and f16 inputs take the same tile, widened to
//   f32 as they are staged (through registers: cp.async cannot widen).
//
// - skinny (kRouteSkinny): at most kM = 8 rows, the conv listener's
//   batch-1 forward and a sampler's one-row step. A 64 x 64 tile there
//   multiplies 63 rows of zeros: AlexNet's two dense layers at m 1 took
//   0.455 ms on the tiled route, 5.5x addmm, against the 0.065 ms that
//   reading their 218 MB of weights takes (NVIDIA H100 80GB HBM3,
//   700 W, chip_smoke.py). The product is a stream of w: each thread
//   owns 4 adjacent columns (one 16-byte load of a w row where n is a
//   multiple of 4 and the pointers are aligned) and all m rows of them
//   in registers, a block's 256 threads are 64 column threads by 4 k
//   lanes (a warp reads 512 contiguous bytes of one w row), each lane
//   walks every 4th k of the block's k chunk with kUnroll rows of w in
//   flight, and the lanes' sums are added in shared memory in a fixed
//   order. x is read through the read-only cache (every thread of a
//   warp reads the same element). K is split over blockIdx.y into the
//   same f32 scratch and finish pass as the tiled route.
//   No route uses atomics: two launches give the same bits.
#include <stdint.h>

#include <type_traits>

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

// --- the wide route ---------------------------------------------------------

// route codes shared with ops/matmul_block.py (ROUTE_CODES)
enum Route { kRouteTiled = 0, kRouteWide = 1, kRouteSkinny = 2 };

namespace wide {
constexpr int kM = 128;                   // output rows per block
constexpr int kNH = 3;                    // 64-column groups of a tile
constexpr int kN = 64 * kNH;              // output columns per block
constexpr int kK = 16;                    // k slice per stage
constexpr int kStages = 4;                // ring depth
constexpr int kThreads = 256;             // 16 x 16, 8 x 4*kNH outputs
constexpr int kXStride = kM + 4;          // floats per k row of x_s
constexpr int kXFloats = kK * kXStride;   // x_s[k][m], k-major
constexpr int kWFloats = kK * kN;         // w_s[k][n]
constexpr int kStageFloats = kXFloats + kWFloats;
constexpr int kSmemBytes = kStages * kStageFloats * 4;  // 82,944
}  // namespace wide

// Stage the k slice [k0, k0 + 16) of the block's x rows and w columns
// into one ring slot: x transposed into xs[kk][row], w as ws[kk][col].
// f32 goes by cp.async (kVec: w in 16-byte copies); bf16 / f16 through
// registers, widened to f32.
template <typename T, bool kVec>
__device__ __forceinline__ void wide_stage(const T* __restrict__ x,
                                           const T* __restrict__ w,
                                           float* xs, float* ws, int m0,
                                           int n0, int k0, int m, int k_len,
                                           int n) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < (wide::kM * wide::kK) / wide::kThreads; ++i) {
    const int idx = tid + i * wide::kThreads;
    const int row = idx >> 4;  // 16 consecutive threads read one x row
    const int kk = idx & 15;
    const bool ok = (m0 + row < m) && (k0 + kk < k_len);
    const T* src = ok ? x + (size_t)(m0 + row) * k_len + (k0 + kk) : x;
    float* dst = xs + kk * wide::kXStride + row;
    if constexpr (std::is_same<T, float>::value)
      dl4j::cp_async4(dst, src, ok ? 4 : 0);
    else
      *dst = ok ? dl4j::to_f32(*src) : 0.0f;
  }
  if constexpr (kVec) {  // f32, n % 4 == 0, w 16-byte aligned
#pragma unroll
    for (int i = 0; i < (wide::kK * wide::kN / 4) / wide::kThreads; ++i) {
      const int idx = tid + i * wide::kThreads;
      const int kk = idx / (wide::kN / 4);  // a w row: kN / 4 threads
      const int c4 = (idx % (wide::kN / 4)) * 4;
      const bool ok = (k0 + kk < k_len) && (n0 + c4 < n);
      const T* src = ok ? w + (size_t)(k0 + kk) * n + (n0 + c4) : w;
      dl4j::cp_async16(ws + kk * wide::kN + c4, src, ok ? 16 : 0);
    }
  } else {
#pragma unroll
    for (int i = 0; i < (wide::kK * wide::kN) / wide::kThreads; ++i) {
      const int idx = tid + i * wide::kThreads;
      const int kk = idx / wide::kN;
      const int col = idx % wide::kN;
      const bool ok = (k0 + kk < k_len) && (n0 + col < n);
      const T* src = ok ? w + (size_t)(k0 + kk) * n + (n0 + col) : w;
      float* dst = ws + kk * wide::kN + col;
      if constexpr (std::is_same<T, float>::value)
        dl4j::cp_async4(dst, src, ok ? 4 : 0);
      else
        *dst = ok ? dl4j::to_f32(*src) : 0.0f;
    }
  }
}

// One 128 x 192 output tile: thread (ty, tx) owns rows ty*4 + {0..3} and
// 64 + ty*4 + {0..3}, columns 64*h + tx*4 + {0..3} for h < kNH.
// kVec (f32 only): w staged in 16-byte copies and the epilogue reads b
// and r and writes out 16 bytes at a time (n % 4 == 0, all aligned).
template <typename T, bool kVec>
__global__ void __launch_bounds__(wide::kThreads, 1)
    matmul_wide_kernel(const T* __restrict__ x, const T* __restrict__ w,
                       const float* __restrict__ bias,
                       const T* __restrict__ res, T* __restrict__ out, int m,
                       int k_len, int n, int act) {
  static_assert(!kVec || std::is_same<T, float>::value,
                "16-byte staging and stores are f32 only");
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int m0 = blockIdx.y * wide::kM;
  const int n0 = blockIdx.x * wide::kN;
  const int num_k = (k_len + wide::kK - 1) / wide::kK;

  constexpr int kJ = 4 * wide::kNH;  // columns a thread owns
  float acc[8][kJ];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < kJ; ++j) acc[i][j] = 0.0f;

  // fill all but one slot of the ring; one commit group per slice
  // (empty past the end) keeps the wait count uniform
#pragma unroll
  for (int s = 0; s < wide::kStages - 1; ++s) {
    if (s < num_k) {
      float* xs = smem + s * wide::kStageFloats;
      wide_stage<T, kVec>(x, w, xs, xs + wide::kXFloats, m0, n0,
                          s * wide::kK, m, k_len, n);
    }
    dl4j::cp_async_commit();
  }

  for (int kt = 0; kt < num_k; ++kt) {
    dl4j::cp_async_wait<wide::kStages - 2>();  // slice kt has landed
    __syncthreads();  // ... for every thread, and slot kt-1 is free
    const int next = kt + wide::kStages - 1;
    if (next < num_k) {
      float* xs = smem + (next % wide::kStages) * wide::kStageFloats;
      wide_stage<T, kVec>(x, w, xs, xs + wide::kXFloats, m0, n0,
                          next * wide::kK, m, k_len, n);
    }
    dl4j::cp_async_commit();

    const float* xs = smem + (kt % wide::kStages) * wide::kStageFloats;
    const float* ws = xs + wide::kXFloats;
#pragma unroll
    for (int kk = 0; kk < wide::kK; ++kk) {
      const float4 a0 =
          *reinterpret_cast<const float4*>(xs + kk * wide::kXStride + ty * 4);
      const float4 a1 = *reinterpret_cast<const float4*>(
          xs + kk * wide::kXStride + 64 + ty * 4);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float b[kJ];
#pragma unroll
      for (int h = 0; h < wide::kNH; ++h) {
        const float4 bh = *reinterpret_cast<const float4*>(
            ws + kk * wide::kN + 64 * h + tx * 4);
        b[4 * h] = bh.x;
        b[4 * h + 1] = bh.y;
        b[4 * h + 2] = bh.z;
        b[4 * h + 3] = bh.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < kJ; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  dl4j::cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + (i - 4));
    if (row >= m) continue;
#pragma unroll
    for (int h = 0; h < wide::kNH; ++h) {
      const int col = n0 + h * 64 + tx * 4;
      if (col >= n) continue;
      const size_t idx = (size_t)row * n + col;
      if constexpr (kVec) {  // col + 3 < n: n and col are multiples of 4
        const float4 bv = *reinterpret_cast<const float4*>(bias + col);
        float z[4] = {acc[i][h * 4] + bv.x, acc[i][h * 4 + 1] + bv.y,
                      acc[i][h * 4 + 2] + bv.z, acc[i][h * 4 + 3] + bv.w};
        if (res != nullptr) {
          const float4 rv = *reinterpret_cast<const float4*>(res + idx);
          z[0] += rv.x;
          z[1] += rv.y;
          z[2] += rv.z;
          z[3] += rv.w;
        }
        *reinterpret_cast<float4*>(out + idx) =
            make_float4(dl4j::apply_act(z[0], act), dl4j::apply_act(z[1], act),
                        dl4j::apply_act(z[2], act), dl4j::apply_act(z[3], act));
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (col + j >= n) continue;
          float z = acc[i][h * 4 + j] + bias[col + j];
          if (res != nullptr) z += dl4j::to_f32(res[idx + j]);
          out[idx + j] = dl4j::from_f32<T>(dl4j::apply_act(z, act));
        }
      }
    }
  }
}

bool aligned16(const void* p) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool kVec>
int launch_wide_as(const T* x, const T* w, const float* bias, const T* res,
                   T* out, int m, int k, int n, int act,
                   cudaStream_t stream) {
  static unsigned smem_set = 0;  // devices whose cap is raised
  auto kernel = matmul_wide_kernel<T, kVec>;
  const int rc = dl4j::allow_dynamic_smem(kernel, wide::kSmemBytes,
                                          &smem_set);
  if (rc != 0) return rc;
  dim3 grid((unsigned)dl4j::ceil_div(n, wide::kN),
            (unsigned)dl4j::ceil_div(m, wide::kM));
  kernel<<<grid, wide::kThreads, wide::kSmemBytes, stream>>>(
      x, w, bias, res, out, m, k, n, act);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wide(const void* x, const void* w, const float* bias,
                const void* res, void* out, int m, int k, int n, int act,
                cudaStream_t stream) {
  if (dl4j::ceil_div(m, wide::kM) > 65535) return (int)cudaErrorInvalidValue;
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  if constexpr (std::is_same<T, float>::value) {
    if (n % 4 == 0 && aligned16(w) && aligned16(bias) && aligned16(res) &&
        aligned16(out))
      return launch_wide_as<T, true>(xt, wt, bias, rt, ot, m, k, n, act,
                                     stream);
  }
  return launch_wide_as<T, false>(xt, wt, bias, rt, ot, m, k, n, act,
                                  stream);
}

// --- the skinny route -------------------------------------------------------

namespace skinny {
constexpr int kM = 8;                      // most rows (SKINNY_MAX_M)
constexpr int kCols = 4;                   // adjacent columns a thread owns
constexpr int kColThreads = 64;
constexpr int kLanes = 4;                  // k lanes of a block
constexpr int kThreads = kColThreads * kLanes;
constexpr int kN = kColThreads * kCols;    // 256 columns a block
constexpr int kUnroll = 4;                 // w rows a lane has in flight
}  // namespace skinny

// The kCols values of w row `row` from column c0 (the columns past n
// read as 0).
template <typename T, bool kVec>
__device__ __forceinline__ void skinny_row(const T* __restrict__ row, int c0,
                                           int n, float (&v)[skinny::kCols]) {
  if constexpr (kVec) {
    const float4 q = *reinterpret_cast<const float4*>(row + c0);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < skinny::kCols; ++j)
      v[j] = c0 + j < n ? dl4j::to_f32(row[c0 + j]) : 0.0f;
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(skinny::kThreads)
    matmul_skinny_kernel(const T* __restrict__ x, const T* __restrict__ w,
                         const float* __restrict__ bias,
                         const T* __restrict__ res, T* __restrict__ out,
                         float* __restrict__ partial, int m, int k_len,
                         int n, int k_chunk, int act) {
  using namespace skinny;
  __shared__ float red[kLanes - 1][kM][kN];
  const int ct = threadIdx.x % kColThreads;
  const int lane = threadIdx.x / kColThreads;
  const int c0 = blockIdx.x * kN + ct * kCols;
  const int k_lo = blockIdx.y * k_chunk;
  const int k_hi = min(k_len, k_lo + k_chunk);

  float acc[kM][kCols];
#pragma unroll
  for (int r = 0; r < kM; ++r)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[r][j] = 0.0f;

  if (c0 < n) {
    int k = k_lo + lane;
    // kUnroll rows of w loaded before any is used
    for (; k + (kUnroll - 1) * kLanes < k_hi; k += kUnroll * kLanes) {
      float v[kUnroll][kCols];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        skinny_row<T, kVec>(w + (size_t)(k + u * kLanes) * n, c0, n, v[u]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int r = 0; r < kM; ++r) {
          if (r >= m) break;
          const float xv =
              dl4j::to_f32(x[(size_t)r * k_len + k + u * kLanes]);
#pragma unroll
          for (int j = 0; j < kCols; ++j)
            acc[r][j] = fmaf(xv, v[u][j], acc[r][j]);
        }
      }
    }
    for (; k < k_hi; k += kLanes) {
      float v[kCols];
      skinny_row<T, kVec>(w + (size_t)k * n, c0, n, v);
#pragma unroll
      for (int r = 0; r < kM; ++r) {
        if (r >= m) break;
        const float xv = dl4j::to_f32(x[(size_t)r * k_len + k]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[r][j] = fmaf(xv, v[j], acc[r][j]);
      }
    }
  }

  // lanes 1..3 hand their sums to lane 0, which adds them in lane order
  if (lane > 0) {
#pragma unroll
    for (int r = 0; r < kM; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        red[lane - 1][r][ct * kCols + j] = acc[r][j];
  }
  __syncthreads();
  if (lane != 0) return;
#pragma unroll
  for (int r = 0; r < kM; ++r) {
    if (r >= m) break;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int col = c0 + j;
      if (col >= n) continue;
      float z = acc[r][j];
#pragma unroll
      for (int l = 0; l < kLanes - 1; ++l) z += red[l][r][ct * kCols + j];
      const size_t idx = (size_t)r * n + col;
      if (partial != nullptr) {
        partial[(size_t)blockIdx.y * m * n + idx] = z;
      } else {
        z += bias[col];
        if (res != nullptr) z += dl4j::to_f32(res[idx]);
        out[idx] = dl4j::from_f32<T>(dl4j::apply_act(z, act));
      }
    }
  }
}

template <typename T>
int launch_skinny(const void* x, const void* w, const float* bias,
                  const void* res, void* out, float* partial, int m, int k,
                  int n, int act, int splits, cudaStream_t stream) {
  if (m > skinny::kM) return (int)cudaErrorInvalidValue;
  int k_chunk = k;
  int z = 1;
  if (splits > 1) {
    if (partial == nullptr || k <= 0) return (int)cudaErrorInvalidValue;
    k_chunk = dl4j::k_chunk_for(k, splits);
    z = dl4j::ceil_div(k, k_chunk);
    if (z > splits) return (int)cudaErrorInvalidValue;
  }
  const T* xt = static_cast<const T*>(x);
  const T* wt = static_cast<const T*>(w);
  const T* rt = static_cast<const T*>(res);
  T* ot = static_cast<T*>(out);
  float* ws = z > 1 ? partial : nullptr;
  dim3 grid((unsigned)dl4j::ceil_div(n, skinny::kN), (unsigned)z);
  bool vec = false;
  if constexpr (std::is_same<T, float>::value)
    vec = n % 4 == 0 && aligned16(w);
  if (vec)
    matmul_skinny_kernel<T, true><<<grid, skinny::kThreads, 0, stream>>>(
        xt, wt, bias, rt, ot, ws, m, k, n, k_chunk, act);
  else
    matmul_skinny_kernel<T, false><<<grid, skinny::kThreads, 0, stream>>>(
        xt, wt, bias, rt, ot, ws, m, k, n, k_chunk, act);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || z == 1) return rc;
  return dl4j::launch_splitk_finish<T>(partial, z, (long long)m * n, nullptr,
                                       bias, 1, n, act, ot, stream, rt);
}

// --- the tiled route's launch -----------------------------------------------

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
// validated by the Python wrapper (ops/matmul_block.py), which also picks
// `route` (enum Route) from the shape; `res` is the [m, n] residual
// (null: none); `partial` is the tiled or skinny route's split-K scratch
// (null when splits is 1; the wide route never splits).
extern "C" int dl4j_matmul_block(const void* x, const void* w,
                                 const void* bias, const void* res,
                                 void* out, void* partial, int dtype, int m,
                                 int k, int n, int act, int splits, int route,
                                 void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const float* b = static_cast<const float*>(bias);
  float* ws = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == kRouteWide) {
    if (splits != 1) return (int)cudaErrorInvalidValue;
    switch (dtype) {
      case dl4j::kF32:
        return launch_wide<float>(x, w, b, res, out, m, k, n, act, st);
      case dl4j::kBF16:
        return launch_wide<__nv_bfloat16>(x, w, b, res, out, m, k, n, act,
                                          st);
      case dl4j::kF16:
        return launch_wide<__half>(x, w, b, res, out, m, k, n, act, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route == kRouteSkinny) {
    switch (dtype) {
      case dl4j::kF32:
        return launch_skinny<float>(x, w, b, res, out, ws, m, k, n, act,
                                    splits, st);
      case dl4j::kBF16:
        return launch_skinny<__nv_bfloat16>(x, w, b, res, out, ws, m, k, n,
                                            act, splits, st);
      case dl4j::kF16:
        return launch_skinny<__half>(x, w, b, res, out, ws, m, k, n, act,
                                     splits, st);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  if (route != kRouteTiled) return (int)cudaErrorInvalidValue;
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
