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
// few microseconds a launch takes: launch latency dominates, and the
// per-step route pays it T times a layer. At b 256, n 1024 it is 2.1
// GFLOP of FP32 FMAs, bound by the SIMT rate.
//
// Design: each block owns a tile of batch rows x kUnits hidden units and
// computes all four gate columns of those units (common.cuh
// `gate_preacts`), so the nonlinearities and the c / h update stay in
// registers and the [b, 4n] pre-activation never reaches device memory,
// as the TPU kernel keeps it in VMEM. RW's slice columns stream through
// shared memory one 32-deep slice at a time; h's tile likewise.

#include "common.cuh"

namespace dl4j {
namespace {

using namespace lstm;

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
  const bool peep = pi != nullptr;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + rg + kRowGroups * i;
    if (r >= b) continue;
    const float* xp = xproj + (size_t)r * 4 * n;
    float zi = xp[unit] + acc[i][0];
    float zf = xp[n + unit] + acc[i][1];
    float zo = xp[2 * n + unit] + acc[i][2];
    const float zg = xp[3 * n + unit] + acc[i][3];
    const size_t o = (size_t)r * n + unit;
    const float cp = c[o];
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

}  // namespace
}  // namespace dl4j

// pi / pf / po: the peephole vectors [n], all three or all null.
extern "C" int dl4j_lstm_cell(const float* xproj, const float* h,
                              const float* c, const float* rw,
                              const float* pi, const float* pf,
                              const float* po, float* h_out, float* c_out,
                              int b, int n, void* stream) {
  using namespace dl4j;
  if (b <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  if ((pi == nullptr) != (pf == nullptr) || (pi == nullptr) != (po == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
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
