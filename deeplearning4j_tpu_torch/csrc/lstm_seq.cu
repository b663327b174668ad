// Whole-sequence LSTM forward and backward, one launch each.
//
// Replaces deeplearning4j_tpu/ops/lstm_cell.py `_seq_fwd_kernel` (:202)
// and `_seq_fwd_kernel_nocseq` (:209), launched by
// `_lstm_sequence_fwd_call` (:334), and `_seq_bwd_kernel` (:217),
// launched by `_lstm_sequence_bwd_call` (:387). Gate order i, f, o, g; no
// peepholes, no mask. f32 in, f32 out, f32 sums; h and c carried in f32.
//
// What bounds them on an H100: the point of the TPU kernels is that RW
// [n, 4n] is read once for the whole sequence, not once a step. Here the
// work of a step is split over blocks by hidden units, and each block
// keeps its units' RW columns resident in shared memory for all T steps
// (n * 128 bytes: 25.6 KB at n 200, 128 KB at n 1024, above 48 KB so the
// launch opts in). Where the columns do not fit, or the card cannot hold
// one block per slice at once, the same code streams them from RW (L2)
// through a 4 KB stage. The steps are serial: every block needs all of
// h_{t-1}, so the grid meets at a barrier once a step. At the char-RNN's
// chunk (T 50, b 32, n 200) the work is 0.5 GFLOP, a bound of ~8 us, and
// the real floor is 50 serial steps of a barrier each; at b 256, n 1024
// it is 275 GFLOP of FP32 FMAs (forward), bound by the SIMT rate.
//
// Design: a persistent grid under a cooperative launch (all blocks are
// resident at once, checked against the occupancy before the launch, so
// the barrier cannot hang). The barrier is a counter and a generation
// word in device memory (`grid_barrier`), which needs no relocatable
// device code. Each block walks its slices (slice = blockIdx.x, +
// gridDim.x, ...) and batch-row tiles; each (row, unit) has one owner
// thread for the whole launch, so the c carry (forward) and the dh / dc
// carries (backward) live in the cT / dh0 / dc0 outputs and are touched
// by their owner only. Values other blocks wrote (h_{t-1}, dgates[t]) are
// read through L2 (__ldcg) after the barrier.
//
// Backward, per step t in reverse: phase 1 recomputes the gates from
// h_{t-1} (resident RW columns), forms dz and the new dc as at
// lstm_cell.py:247-255 and writes dz to dgates[t]; barrier; phase 2 forms
// dh_{t-1}[:, own units] = dgates[t] . RW[own units, :]^T from the RW rows
// of the block's units (read through L1 / L2: both halves of RW resident
// would need twice the card's shared memory at n 1024). One barrier a
// step suffices: phase 2 of step t only reads dgates[t], and phase 1 of
// step t-1 only writes dgates[t-1] and reads its own carries.

#include "common.cuh"

namespace dl4j {
namespace {

using namespace lstm;

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Grid-wide barrier: bar[0] counts arrivals, bar[1] is the generation.
// Every block must be resident (cooperative launch).
__device__ __forceinline__ void grid_barrier(unsigned* bar) {
  __threadfence();  // this thread's writes, before its block arrives
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned gen = load_acquire(bar + 1);
    if (atomicAdd(bar, 1u) == gridDim.x - 1) {
      atomicExch(bar, 0u);
      __threadfence();
      atomicAdd(bar + 1, 1u);
    } else {
      while (load_acquire(bar + 1) == gen) __nanosleep(32);
    }
    __threadfence();
  }
  __syncthreads();
}

__device__ __forceinline__ void store_l2(float* p, float v) { __stcg(p, v); }

template <int RPT, bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
    lstm_seq_fwd_kernel(const float* __restrict__ xproj,
                        const float* __restrict__ rw,
                        const float* __restrict__ h0,
                        const float* __restrict__ c0, float* hseq,
                        float* __restrict__ cseq, float* __restrict__ hT,
                        float* __restrict__ cT, unsigned* bar, int T, int b,
                        int n) {
  extern __shared__ float4 smem4[];
  float* rw_area = reinterpret_cast<float*>(smem4);
  float* h_s = rw_area + (RESIDENT ? n * kCols : kKTile * kCols);
  constexpr int br = kRowGroups * RPT;
  const int n_slices = slices(n);
  const int u = threadIdx.x % kUnits, rg = threadIdx.x / kUnits;
  const size_t bn = (size_t)b * n;
  // RESIDENT: one slice a block, its columns loaded once for all T
  if (RESIDENT) load_rw_cols(rw, n, blockIdx.x * kUnits, 0, n, rw_area);
  // the c carry lives in cT, each entry touched by its owner thread only
  for (int s = blockIdx.x; s < n_slices; s += gridDim.x) {
    const int unit = s * kUnits + u;
    for (int row0 = 0; row0 < b; row0 += br) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = row0 + rg + kRowGroups * i;
        if (r < b && unit < n) cT[(size_t)r * n + unit] = c0[(size_t)r * n + unit];
      }
    }
  }
  for (int t = 0; t < T; ++t) {
    const float* hp = t == 0 ? h0 : hseq + (size_t)(t - 1) * bn;
    const float* xt = xproj + (size_t)t * 4 * bn;
    float* ht = hseq + (size_t)t * bn;
    for (int s = blockIdx.x; s < n_slices; s += gridDim.x) {
      const int unit0 = s * kUnits, unit = unit0 + u;
      for (int row0 = 0; row0 < b; row0 += br) {
        float acc[RPT][4];
        gate_preacts<RPT>(hp, b, n, row0, rw, unit0,
                          RESIDENT ? rw_area : nullptr, rw_area, h_s, acc);
        if (unit >= n) continue;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = row0 + rg + kRowGroups * i;
          if (r >= b) continue;
          const float* xp = xt + (size_t)r * 4 * n;
          const float zi = xp[unit] + acc[i][0];
          const float zf = xp[n + unit] + acc[i][1];
          const float zo = xp[2 * n + unit] + acc[i][2];
          const float zg = xp[3 * n + unit] + acc[i][3];
          const size_t o = (size_t)r * n + unit;
          const float cp = cT[o];
          const float ig = sigmoid(zi), fg = sigmoid(zf), gg = tanhf(zg);
          const float cn = fg * cp + ig * gg;
          const float hn = sigmoid(zo) * tanhf(cn);
          store_l2(ht + o, hn);
          if (cseq != nullptr) cseq[(size_t)t * bn + o] = cn;
          cT[o] = cn;
          if (t == T - 1) hT[o] = hn;
        }
      }
    }
    if (t + 1 < T) grid_barrier(bar);
  }
}

// dh_{t-1}[r][unit] = sum_j dg[r][j] * RW[unit][j] for the thread's rows
// and unit; dg = dgates[t] [b, 4n], written by every block this step.
template <int RPT>
__device__ __forceinline__ void dh_prev(const float* dg, int b, int n,
                                        int row0,
                                        const float* __restrict__ rw,
                                        int unit0, float* dg_s, float* rwr_s,
                                        float out[RPT]) {
  const int u = threadIdx.x % kUnits, rg = threadIdx.x / kUnits;
  constexpr int br = kRowGroups * RPT;
  const int four_n = 4 * n;
#pragma unroll
  for (int i = 0; i < RPT; ++i) out[i] = 0.0f;
  for (int j0 = 0; j0 < four_n; j0 += kJTile) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < br * kJTile; idx += kThreads) {
      const int r = idx / kJTile, jj = idx % kJTile;
      const int gr = row0 + r, gj = j0 + jj;
      dg_s[r * kJStride + jj] =
          (gr < b && gj < four_n) ? __ldcg(dg + (size_t)gr * four_n + gj)
                                  : 0.0f;
    }
    for (int idx = threadIdx.x; idx < kUnits * kJTile; idx += kThreads) {
      const int uu = idx / kJTile, jj = idx % kJTile;
      const int gu = unit0 + uu, gj = j0 + jj;
      rwr_s[uu * kJStride + jj] =
          (gu < n && gj < four_n) ? __ldg(rw + (size_t)gu * four_n + gj)
                                  : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int jj = 0; jj < kJTile; jj += 4) {
      const float4 w =
          *reinterpret_cast<const float4*>(rwr_s + u * kJStride + jj);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 d = *reinterpret_cast<const float4*>(
            dg_s + (rg + kRowGroups * i) * kJStride + jj);
        out[i] = fmaf(d.x, w.x, out[i]);
        out[i] = fmaf(d.y, w.y, out[i]);
        out[i] = fmaf(d.z, w.z, out[i]);
        out[i] = fmaf(d.w, w.w, out[i]);
      }
    }
  }
}

template <int RPT, bool RESIDENT>
__global__ void __launch_bounds__(kThreads)
    lstm_seq_bwd_kernel(const float* __restrict__ xproj,
                        const float* __restrict__ hprev,
                        const float* __restrict__ cprev,
                        const float* __restrict__ cseq,
                        const float* __restrict__ rw,
                        const float* __restrict__ dhseq,
                        const float* __restrict__ dhT,
                        const float* __restrict__ dcT, float* dgates,
                        float* __restrict__ dh0, float* __restrict__ dc0,
                        unsigned* bar, int T, int b, int n) {
  extern __shared__ float4 smem4[];
  float* rw_area = reinterpret_cast<float*>(smem4);
  float* tile = rw_area + (RESIDENT ? n * kCols : kKTile * kCols);
  constexpr int br = kRowGroups * RPT;
  float* dg_s = tile;                        // phase 2 (aliases h tile)
  float* rwr_s = tile + br * kJStride;
  const int n_slices = slices(n);
  const int u = threadIdx.x % kUnits, rg = threadIdx.x / kUnits;
  const size_t bn = (size_t)b * n;
  if (RESIDENT) load_rw_cols(rw, n, blockIdx.x * kUnits, 0, n, rw_area);
  // the dh / dc carries live in dh0 / dc0, touched by their owners only
  for (int s = blockIdx.x; s < n_slices; s += gridDim.x) {
    const int unit = s * kUnits + u;
    for (int row0 = 0; row0 < b; row0 += br) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const int r = row0 + rg + kRowGroups * i;
        if (r < b && unit < n) {
          const size_t o = (size_t)r * n + unit;
          dh0[o] = dhT[o];
          dc0[o] = dcT[o];
        }
      }
    }
  }
  for (int t = T - 1; t >= 0; --t) {
    const float* xt = xproj + (size_t)t * 4 * bn;
    float* dgt = dgates + (size_t)t * 4 * bn;
    // phase 1: gates from h_{t-1}, dz to dgates[t], the dc carry
    for (int s = blockIdx.x; s < n_slices; s += gridDim.x) {
      const int unit0 = s * kUnits, unit = unit0 + u;
      for (int row0 = 0; row0 < b; row0 += br) {
        float acc[RPT][4];
        gate_preacts<RPT>(hprev + (size_t)t * bn, b, n, row0, rw, unit0,
                          RESIDENT ? rw_area : nullptr, rw_area, tile, acc);
        if (unit >= n) continue;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = row0 + rg + kRowGroups * i;
          if (r >= b) continue;
          const float* xp = xt + (size_t)r * 4 * n;
          const float ig = sigmoid(xp[unit] + acc[i][0]);
          const float fg = sigmoid(xp[n + unit] + acc[i][1]);
          const float og = sigmoid(xp[2 * n + unit] + acc[i][2]);
          const float gg = tanhf(xp[3 * n + unit] + acc[i][3]);
          const size_t o = (size_t)r * n + unit;
          const size_t ot = (size_t)t * bn + o;
          const float c_prev = cprev[ot];
          const float tc = tanhf(cseq[ot]);
          const float dh = dhseq[ot] + dh0[o];
          const float d_o = dh * tc;
          const float dct = dh * og * (1.0f - tc * tc) + dc0[o];
          const float dzo = d_o * og * (1.0f - og);
          const float dzf = (dct * c_prev) * fg * (1.0f - fg);
          const float dzi = (dct * gg) * ig * (1.0f - ig);
          const float dzg = (dct * ig) * (1.0f - gg * gg);
          dc0[o] = dct * fg;
          float* dz = dgt + (size_t)r * 4 * n;
          store_l2(dz + unit, dzi);
          store_l2(dz + n + unit, dzf);
          store_l2(dz + 2 * n + unit, dzo);
          store_l2(dz + 3 * n + unit, dzg);
        }
      }
    }
    grid_barrier(bar);
    // phase 2: dh_{t-1} for the block's units from all of dgates[t]
    for (int s = blockIdx.x; s < n_slices; s += gridDim.x) {
      const int unit0 = s * kUnits, unit = unit0 + u;
      for (int row0 = 0; row0 < b; row0 += br) {
        float out[RPT];
        dh_prev<RPT>(dgt, b, n, row0, rw, unit0, dg_s, rwr_s, out);
        if (unit >= n) continue;
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int r = row0 + rg + kRowGroups * i;
          if (r < b) dh0[(size_t)r * n + unit] = out[i];
        }
      }
    }
  }
}

// Shared memory of a launch (bytes): the RW area (resident columns or
// the stage) and the tile area (forward: h tile; backward: the larger
// of the h tile and phase 2's dgates + RW-row tiles).
size_t smem_bytes(bool bwd, bool resident, int rpt, int n) {
  const size_t rw_area = resident ? (size_t)n * kCols : kKTile * kCols;
  size_t tile = h_tile_floats(rpt);
  if (bwd) {
    const size_t p2 = (size_t)(kRowGroups * rpt + kUnits) * kJStride;
    if (p2 > tile) tile = p2;
  }
  return (rw_area + tile) * sizeof(float);
}

template <int RPT, bool RESIDENT>
const void* kernel_for(bool bwd) {
  return bwd ? (const void*)lstm_seq_bwd_kernel<RPT, RESIDENT>
             : (const void*)lstm_seq_fwd_kernel<RPT, RESIDENT>;
}

const void* pick_kernel(bool bwd, bool resident, int rpt) {
  switch (rpt) {
    case 1:
      return resident ? kernel_for<1, true>(bwd) : kernel_for<1, false>(bwd);
    case 2:
      return resident ? kernel_for<2, true>(bwd) : kernel_for<2, false>(bwd);
    case 4:
      return resident ? kernel_for<4, true>(bwd) : kernel_for<4, false>(bwd);
    default:
      return resident ? kernel_for<8, true>(bwd) : kernel_for<8, false>(bwd);
  }
}

// Blocks of `fn` the whole card holds at once with `smem` bytes each.
int resident_blocks(const void* fn, size_t smem, int* err) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e == cudaSuccess && smem > (size_t)optin) return 0;
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  *err = (int)e;
  return e == cudaSuccess ? per_sm * sms : 0;
}

// The launch plan: resident RW columns when each slice can have a block
// of its own with them in shared memory, else the streamed kernel on as
// many blocks as the card holds (at most one a slice).
struct Plan {
  const void* fn;
  int grid;
  size_t smem;
  bool resident;
};

int plan(bool bwd, int b, int n, Plan* p) {
  const int rpt = rows_per_thread(b), n_slices = slices(n);
  int err = 0;
  p->resident = true;
  p->fn = pick_kernel(bwd, true, rpt);
  p->smem = smem_bytes(bwd, true, rpt, n);
  int fit = resident_blocks(p->fn, p->smem, &err);
  if (err != 0) return err;
  if (fit < n_slices) {
    p->resident = false;
    p->fn = pick_kernel(bwd, false, rpt);
    p->smem = smem_bytes(bwd, false, rpt, n);
    fit = resident_blocks(p->fn, p->smem, &err);
    if (err != 0) return err;
  }
  if (fit <= 0) return (int)cudaErrorCooperativeLaunchTooLarge;
  p->grid = fit < n_slices ? fit : n_slices;
  return 0;
}

int launch(bool bwd, int b, int n, void** args, cudaStream_t stream) {
  Plan p;
  int rc = plan(bwd, b, n, &p);
  if (rc != 0) return rc;
  rc = (int)cudaLaunchCooperativeKernel(p.fn, dim3(p.grid), dim3(kThreads),
                                        args, p.smem, stream);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dl4j

// The launch plan for a (b, n): writes the grid size and whether RW's
// columns are resident (1) or streamed (0); returns a CUDA error code.
extern "C" int dl4j_lstm_seq_plan(int bwd, int b, int n, int* grid,
                                  int* resident) {
  dl4j::Plan p;
  const int rc = dl4j::plan(bwd != 0, b, n, &p);
  if (rc == 0) {
    *grid = p.grid;
    *resident = p.resident ? 1 : 0;
  }
  return rc;
}

// cseq may be null (the inference variant). barrier: two zeroed
// unsigned ints of device memory, used by this launch alone.
extern "C" int dl4j_lstm_seq_fwd(const float* xproj, const float* rw,
                                 const float* h0, const float* c0,
                                 float* hseq, float* cseq, float* hT,
                                 float* cT, unsigned* barrier, int T, int b,
                                 int n, void* stream) {
  if (T <= 0 || b <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&xproj, &rw, &h0, &c0, &hseq, &cseq,
                  &hT, &cT, &barrier, &T, &b, &n};
  return dl4j::launch(false, b, n, args, static_cast<cudaStream_t>(stream));
}

extern "C" int dl4j_lstm_seq_bwd(const float* xproj, const float* hprev,
                                 const float* cprev, const float* cseq,
                                 const float* rw, const float* dhseq,
                                 const float* dhT, const float* dcT,
                                 float* dgates, float* dh0, float* dc0,
                                 unsigned* barrier, int T, int b, int n,
                                 void* stream) {
  if (T <= 0 || b <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&xproj, &hprev, &cprev, &cseq, &rw, &dhseq, &dhT,
                  &dcT, &dgates, &dh0, &dc0, &barrier, &T, &b, &n};
  return dl4j::launch(true, b, n, args, static_cast<cudaStream_t>(stream));
}
