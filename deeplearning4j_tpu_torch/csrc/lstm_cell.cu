// One fused LSTM timestep, with or without Graves peepholes.
//
// Replaces deeplearning4j_tpu/ops/lstm_cell.py `_cell_kernel` (:28) and
// `_peephole_kernel` (:54), the per-step kernel that `lstm_cell` (:60)
// and `lstm_cell_diff` (:113) launch once a timestep:
//   z = xproj + h @ RW; zi += c pI, zf += c pF (peepholes);
//   i, f, o = sigmoid; g = tanh; c' = f c + i g; zo += c' pO; h' = o tanh(c').
// f32 in, f32 out, f32 sums.
//
// What bounds it on an H100: at the char-RNN's shape (b 32, n 200) one
// launch is ~10 MFLOP over ~0.85 MB, a bound of ~0.25 us, far below the
// few microseconds a launch takes: latency, not the FMA rate or the
// bytes, sets its time, and the per-step route pays it T times a layer.
// At b 256, n 1024 it is 2.1 GFLOP of FP32 FMAs, bound by the SIMT rate.
//
// Two routes, picked by the wrapper from the shape alone
// (ops/lstm_cell.py lstm_cell_route) and passed in as `route`. Both
// compute all four gate columns of a unit in one block, so the
// nonlinearities and the c / h update stay in registers and the [b, 4n]
// pre-activation never reaches device memory, as the TPU kernel keeps it
// in VMEM.
//
// - slice (kRouteSlice): a block owns a tile of batch rows x 8 hidden
//   units (common.cuh `gate_preacts`); RW's slice columns and h's tile
//   stream through shared memory one 32-deep slice at a time. It keeps
//   the SIMT-bound shapes (b 256, n 1024), where its 25-row-group tiles
//   reuse each staged column; at the char-RNN's shape its grid is 25
//   blocks and each walks 7 dependent depth slices (two barriers and an
//   L2 round trip each): 15.5 us.
// - latency (kRouteLatency): where a block's rows of h and its columns
//   of RW fit in 48 KB of shared memory. A block owns `units` hidden
//   units (2 at n 200: 100 blocks) for `rows` batch rows (up to 32),
//   and its 256 threads issue every copy it needs (its h rows in
//   16-byte cp.async where aligned, its 4 x units RW columns in 4-byte
//   ones) before one wait and one barrier; the epilogue's xproj and c
//   load into registers while the copies fly. Thread
//   (row, unit, s) sums depth rows s, s + splits, ... of its four gates;
//   the `splits` lanes of a (row, unit) are adjacent in a warp and add
//   their sums by xor shuffles in a fixed order, so two launches give
//   the same bits. Lane 0 of each group runs the gates and stores h, c.

#include <stdint.h>

#include "common.cuh"

namespace dl4j {
namespace {

using namespace lstm;

// route codes shared with ops/lstm_cell.py (CELL_ROUTE_CODES)
enum CellRoute { kRouteSlice = 0, kRouteLatency = 1 };

// the gates of one (row, unit): z* are the pre-activations, cp the
// previous cell state; writes h_out, c_out at o
__device__ __forceinline__ void cell_gates(float zi, float zf, float zo,
                                           float zg, float cp,
                                           const float* pi, const float* pf,
                                           const float* po, int unit,
                                           float* h_out, float* c_out,
                                           size_t o) {
  const bool peep = pi != nullptr;
  if (peep) {
    zi += cp * pi[unit];
    zf += cp * pf[unit];
  }
  const float ig = sigmoid(zi), fg = sigmoid(zf), gg = tanhf(zg);
  const float cn = fg * cp + ig * gg;
  if (peep) zo += cn * po[unit];
  const float og = sigmoid(zo);
  h_out[o] = og * tanhf(cn);
  c_out[o] = cn;
}

template <int RPT>
__global__ void __launch_bounds__(kThreads)
    lstm_cell_kernel(const float* __restrict__ xproj, const float* h,
                     const float* __restrict__ c,
                     const float* __restrict__ rw,
                     const float* __restrict__ pi,
                     const float* __restrict__ pf,
                     const float* __restrict__ po, float* __restrict__ h_out,
                     float* __restrict__ c_out, int b, int n) {
  extern __shared__ float4 smem4[];
  float* rw_stage = reinterpret_cast<float*>(smem4);
  float* h_s = rw_stage + kKTile * kCols;
  const int unit0 = blockIdx.x * kUnits;
  const int row0 = blockIdx.y * kRowGroups * RPT;
  float acc[RPT][4];
  gate_preacts<RPT>(h, b, n, row0, rw, unit0, nullptr, rw_stage, h_s, acc);
  const int unit = unit0 + threadIdx.x % kUnits;
  const int rg = threadIdx.x / kUnits;
  if (unit >= n) return;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + rg + kRowGroups * i;
    if (r >= b) continue;
    const float* xp = xproj + (size_t)r * 4 * n;
    cell_gates(xp[unit] + acc[i][0], xp[n + unit] + acc[i][1],
               xp[2 * n + unit] + acc[i][2], xp[3 * n + unit] + acc[i][3],
               c[(size_t)r * n + unit], pi, pf, po, unit, h_out, c_out,
               (size_t)r * n + unit);
  }
}

template <int RPT>
int launch_cell(const float* xproj, const float* h, const float* c,
                const float* rw, const float* pi, const float* pf,
                const float* po, float* h_out, float* c_out, int b, int n,
                cudaStream_t stream) {
  const dim3 grid(slices(n), (b + kRowGroups * RPT - 1) / (kRowGroups * RPT));
  const size_t smem = (kKTile * kCols + h_tile_floats(RPT)) * sizeof(float);
  lstm_cell_kernel<RPT><<<grid, kThreads, smem, stream>>>(
      xproj, h, c, rw, pi, pf, po, h_out, c_out, b, n);
  return (int)cudaGetLastError();
}

// --- the latency route --------------------------------------------------

// a block's threads: rows x units x splits of them sum, all of them copy
constexpr int kLatencyThreads = 256;
constexpr int kLatencySmemBytes = 48 * 1024;  // no opt-in needed

// h row stride in shared memory: n rounded up to 4 floats (16 bytes)
__host__ __device__ inline int latency_h_stride(int n) {
  return (n + 3) / 4 * 4;
}

// Dynamic shared memory of a latency block (the formula of
// ops/lstm_cell.py lstm_cell_smem_bytes): rows h rows, then n depth rows
// of the block's 4 x units RW columns, unit-major and gate-minor.
__host__ __device__ inline int latency_smem_bytes(int n, int rows,
                                                  int units) {
  return 4 * (rows * latency_h_stride(n) + n * units * 4);
}

__global__ void __launch_bounds__(kLatencyThreads)
    lstm_cell_latency_kernel(const float* __restrict__ xproj,
                             const float* __restrict__ h,
                             const float* __restrict__ c,
                             const float* __restrict__ rw,
                             const float* __restrict__ pi,
                             const float* __restrict__ pf,
                             const float* __restrict__ po,
                             float* __restrict__ h_out,
                             float* __restrict__ c_out, int b, int n,
                             int rows, int units, int splits, int vec) {
  extern __shared__ float4 smem4[];
  const int hs = latency_h_stride(n);
  float* h_s = reinterpret_cast<float*>(smem4);  // [rows][hs]
  float* w_s = h_s + rows * hs;                  // [n][units][4]
  const int unit0 = blockIdx.x * units;
  const int row0 = blockIdx.y * rows;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;

  // every copy of the block, issued before the one wait
  if (vec) {  // n % 4 == 0 and h 16-byte aligned: rows of n / 4 float4
    const int q = n / 4;
    for (int idx = tid; idx < rows * q; idx += nt) {
      const int r = idx / q, k4 = (idx - r * q) * 4;
      const bool ok = row0 + r < b;
      const float* src = ok ? h + (size_t)(row0 + r) * n + k4 : h;
      cp_async16(h_s + r * hs + k4, src, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < rows * n; idx += nt) {
      const int r = idx / n, k = idx - r * n;
      const bool ok = row0 + r < b;
      const float* src = ok ? h + (size_t)(row0 + r) * n + k : h;
      cp_async4(h_s + r * hs + k, src, ok ? 4 : 0);
    }
  }
  const int cols = 4 * units;
  for (int idx = tid; idx < n * cols; idx += nt) {
    // adjacent threads: adjacent units of one gate (coalesced reads)
    const int k = idx / cols, cc = idx - k * cols;
    const int g = cc / units, u = cc - g * units;
    const bool ok = unit0 + u < n;
    const float* src = ok ? rw + (size_t)k * 4 * n + g * n + unit0 + u : rw;
    cp_async4(w_s + (k * units + u) * 4 + g, src, ok ? 4 : 0);
  }
  cp_async_commit();

  const int s = tid % splits;
  const int ru = tid / splits;
  const int r = ru / units, u = ru - r * units;
  const bool live = ru < rows * units;  // the rest only copy
  const int row = row0 + r, unit = unit0 + u;
  const bool owner = live && s == 0 && row < b && unit < n;
  float xp[4] = {0.0f, 0.0f, 0.0f, 0.0f}, cp = 0.0f;
  if (owner) {  // the epilogue's operands, while the copies fly
    const float* x = xproj + (size_t)row * 4 * n + unit;
#pragma unroll
    for (int g = 0; g < 4; ++g) xp[g] = __ldg(x + g * n);
    cp = __ldg(c + (size_t)row * n + unit);
  }
  cp_async_wait<0>();
  __syncthreads();

  float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (live) {
    const float* hr = h_s + r * hs;
    const float4* w4 = reinterpret_cast<const float4*>(w_s) + u;
#pragma unroll 4
    for (int k = s; k < n; k += splits) {
      const float hv = hr[k];
      const float4 wv = w4[k * units];
      acc[0] = fmaf(hv, wv.x, acc[0]);
      acc[1] = fmaf(hv, wv.y, acc[1]);
      acc[2] = fmaf(hv, wv.z, acc[2]);
      acc[3] = fmaf(hv, wv.w, acc[3]);
    }
  }
  // the splits lanes of a group are adjacent and aligned (splits is a
  // power of two up to 32): a fixed xor tree
  for (int off = splits / 2; off > 0; off /= 2) {
#pragma unroll
    for (int g = 0; g < 4; ++g)
      acc[g] += __shfl_xor_sync(0xffffffffu, acc[g], off);
  }
  if (owner)
    cell_gates(xp[0] + acc[0], xp[1] + acc[1], xp[2] + acc[2],
               xp[3] + acc[3], cp, pi, pf, po, unit, h_out, c_out,
               (size_t)row * n + unit);
}

bool latency_plan_ok(int b, int n, int rows, int units, int splits) {
  if (rows < 1 || units < 1 || splits < 1 || splits > 32 ||
      (splits & (splits - 1)) != 0)
    return false;
  const long long threads = (long long)rows * units * splits;
  if (threads > kLatencyThreads) return false;
  if (latency_smem_bytes(n, rows, units) > kLatencySmemBytes) return false;
  return ceil_div(b, rows) <= 65535;  // the grid's y extent
}

int launch_latency(const float* xproj, const float* h, const float* c,
                   const float* rw, const float* pi, const float* pf,
                   const float* po, float* h_out, float* c_out, int b, int n,
                   int rows, int units, int splits, cudaStream_t stream) {
  if (!latency_plan_ok(b, n, rows, units, splits))
    return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && (reinterpret_cast<uintptr_t>(h) & 15) == 0;
  const dim3 grid(ceil_div(n, units), ceil_div(b, rows));
  lstm_cell_latency_kernel<<<grid, kLatencyThreads,
                             latency_smem_bytes(n, rows, units), stream>>>(xproj, h, c, rw, pi, pf, po, h_out,
                                       c_out, b, n, rows, units, splits,
                                       vec ? 1 : 0);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dl4j

// The latency route's plan at (b, n): one block's dynamic shared memory
// and threads, or -1 in both when the plan is refused.
extern "C" int dl4j_lstm_cell_plan(int b, int n, int rows, int units,
                                   int splits, int* smem_bytes,
                                   int* threads) {
  using namespace dl4j;
  const bool ok = b > 0 && n > 0 && latency_plan_ok(b, n, rows, units, splits);
  *smem_bytes = ok ? latency_smem_bytes(n, rows, units) : -1;
  *threads = ok ? kLatencyThreads : -1;
  return 0;
}

// pi / pf / po: the peephole vectors [n], all three or all null. route:
// enum CellRoute; rows, units and splits are the latency route's plan
// (ops/lstm_cell.py lstm_cell_route), unused on the slice route.
extern "C" int dl4j_lstm_cell(const float* xproj, const float* h,
                              const float* c, const float* rw,
                              const float* pi, const float* pf,
                              const float* po, float* h_out, float* c_out,
                              int b, int n, int route, int rows, int units,
                              int splits, void* stream) {
  using namespace dl4j;
  if (b <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if ((pi == nullptr) != (pf == nullptr) || (pi == nullptr) != (po == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == kRouteLatency)
    return launch_latency(xproj, h, c, rw, pi, pf, po, h_out, c_out, b, n,
                          rows, units, splits, s);
  if (route != kRouteSlice) return (int)cudaErrorInvalidValue;
  switch (lstm::rows_per_thread(b)) {
    case 1:
      return launch_cell<1>(xproj, h, c, rw, pi, pf, po, h_out, c_out, b, n, s);
    case 2:
      return launch_cell<2>(xproj, h, c, rw, pi, pf, po, h_out, c_out, b, n, s);
    case 4:
      return launch_cell<4>(xproj, h, c, rw, pi, pf, po, h_out, c_out, b, n, s);
    default:
      return launch_cell<8>(xproj, h, c, rw, pi, pf, po, h_out, c_out, b, n, s);
  }
}
