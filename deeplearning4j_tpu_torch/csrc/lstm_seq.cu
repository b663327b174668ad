// Whole-sequence LSTM forward and backward, one launch each, on one of
// two routes that the wrapper picks from the shape alone
// (ops/lstm_cell.py lstm_seq_route) and passes in.
//
// Replaces deeplearning4j_tpu/ops/lstm_cell.py `_seq_fwd_kernel` (:202)
// and `_seq_fwd_kernel_nocseq` (:209), launched by
// `_lstm_sequence_fwd_call` (:334), and `_seq_bwd_kernel` (:217),
// launched by `_lstm_sequence_bwd_call` (:387). Gate order i, f, o, g; no
// peepholes, no mask. f32 in, f32 out, f32 sums; h and c carried in f32.
//
// What bounds them on an H100: the steps are serial, and each needs all
// of h_{t-1}. At the char-RNN's chunk (T 50, b 32, n 200) the work is
// 0.5 GFLOP (forward), a bound of ~8 us, far below the latency of 50
// dependent steps: the pace is set by what one step waits for. At b
// 256, n 1024 it is 275 GFLOP of FP32 FMAs, bound by the SIMT rate.
//
// Cluster route (n <= 256 at up to 8 blocks a cluster; the TPU kernel's
// batch block, grid=(b // bb, T), on Hopper): a thread-block cluster owns
// `rows` batch rows for the whole sequence. Batch rows are independent
// in the recurrence, so clusters never meet: no grid barrier, no barrier
// word, a plain launch with a cluster dimension. Block k of the cluster
// owns units [k U, (k+1) U), U = ceil(n / C), C = ceil(n / ceil(n / 8))
// so that every block owns at least one unit, and keeps those units' 4
// gate columns of RW resident in shared memory for all T steps (80 KB at
// n 200). h_t is exchanged through distributed shared memory: each
// owner thread stores its new h into every peer's h buffer
// (double-buffered by step parity) with st.async, which counts the bytes
// off the peer's mbarrier; a block waits for the n x rows values it
// expects and nothing else, so no cluster-wide barrier and no fence over
// the step's stores to device memory sits on the recurrence. A barrier's
// next phase is armed only after the block barrier that follows its
// wait, so it cannot complete before every thread has seen the phase
// before it. The gate product then reads h_{t-1} from local shared
// memory: 256 threads, each a unit and a short depth slice (many short
// chains: the product is bound by the latency of its shared loads),
// partial sums added by the owner thread in a fixed order. The carries
// (c; dh, dc) stay in the owner thread's registers; hT / cT and dh0 /
// dc0 are written once. The gates use expf / tanhf, as the grid route
// and the plain versions do. xproj and the backward's saved c_{t-1} /
// c_t / dh_t are fetched a step ahead into registers, hprev a step ahead
// by cp.async.
// The backward is a split-K over the block's columns: a block forms dz
// for its units, and thread k the partial dh_{t-1}[r, k] = sum over the
// block's columns j of dz[r, j] RW[k, j], from row k of those columns
// held in its registers, and sends it to the block that owns unit k;
// each owner adds the C partials in rank order: no RW rows streamed, no
// atomics, the same bits every launch. The backward's gate recompute for
// step t-1 (from hprev, off the recurrence) runs while step t's partials
// are in flight. Bounded by the latency of a step: at the chunk about
// 2.0 us forward (product, owner sums and gates, exchange) and 4.0 us
// backward (the gate recompute adds about a forward step).
//
// Grid route (every other shape: bench.py's T 128, b 256, n 1024, where
// RW's columns need 16 MB, and n 8500): the work of a step is split over
// blocks by hidden units, and each block keeps its units' RW columns
// resident in shared memory for all T steps (n * 128 bytes: 25.6 KB at n
// 200, 128 KB at n 1024, above 48 KB so the launch opts in). Where the
// columns do not fit, or the card cannot hold one block per slice at
// once, the same code streams them from RW (L2) through a 4 KB stage.
// Every block needs all of h_{t-1}, so the grid meets at a barrier once
// a step: a persistent grid under a cooperative launch (all blocks are
// resident at once, checked against the occupancy before the launch, so
// the barrier cannot hang). The barrier is a counter and a generation
// word in device memory (`grid_barrier`), which needs no relocatable
// device code. Each block walks its slices (slice = blockIdx.x, +
// gridDim.x, ...) and batch-row tiles; each (row, unit) has one owner
// thread for the whole launch, so the c carry (forward) and the dh / dc
// carries (backward) live in the cT / dh0 / dc0 outputs and are touched
// by their owner only. Values other blocks wrote (h_{t-1}, dgates[t]) are
// read through L2 (__ldcg) after the barrier. Bounded at the saturated
// shape by FP32 SIMT and the un-overlapped tile loads.
//
// Grid backward, per step t in reverse: phase 1 recomputes the gates from
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

// --- the cluster route -------------------------------------------------

constexpr int kClusterMaxBlocks = 8;   // portable cluster size
constexpr int kClusterMaxUnits = 32;   // units a block (rows x U <= 256)
constexpr int kClusterMaxSplits = 16;  // depth splits of the gate product
// dynamic shared memory a cluster block may take: the card's 227 KB less
// 1 KB for the kernels' static shared memory (the mbarriers)
constexpr int kClusterSmemCap = kMaxSmemBytes - 1024;

// A cluster's split of n over its C blocks: U units a block; the gate
// product's KS depth splits of dk rows for its U * KS <= 256 threads
// (many threads of short depth: the product is bound by the latency of
// its shared-memory loads); the row stride rs of the resident columns
// (4 * (U | 1) floats: 8 threads reading rows at that stride hit 32
// distinct banks).
struct ClusterShape {
  int U, rs, KS, dk;
};

__host__ __device__ inline ClusterShape cluster_shape(int n, int C) {
  ClusterShape s;
  s.U = (n + C - 1) / C;
  s.rs = 4 * (s.U | 1);
  int ks = kThreads / s.U;
  if (ks > kClusterMaxSplits) ks = kClusterMaxSplits;
  if (ks > n) ks = n;
  s.KS = ks;
  s.dk = (n + ks - 1) / ks;
  return s;
}

__host__ __device__ inline int round4(int v) { return (v + 3) / 4 * 4; }

// Floats of a cluster block's dynamic shared memory: the resident gate
// columns of its units (n x rs), two h buffers (n x B, k-major) and the
// gate product's partial sums (KS x B x U float4); backward also dz (B x
// U float4) and two buffers of dh partials (2 x C x B x U). Mirrored by
// ops/lstm_cell.py lstm_cluster_smem_bytes.
__host__ __device__ inline int cluster_smem_floats(bool bwd, int n, int C,
                                                   int B) {
  const ClusterShape s = cluster_shape(n, C);
  const int f = n * s.rs + round4(2 * n * B) + s.KS * B * s.U * 4;
  if (!bwd) return f;
  return f + B * s.U * 4 + round4(2 * C * B * s.U);
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}
__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(r));
  return r;
}
// The shared::cluster address of `local` (this block's shared memory)
// in block `rank` of the cluster.
__device__ __forceinline__ unsigned peer_addr(const void* local,
                                              unsigned rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(out)
               : "r"(smem_addr(local)), "r"(rank));
  return out;
}
// The hardware cluster barrier (release / acquire): once, after the
// mbarriers are set up, so that no block stores into a peer that has
// not started.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

// The exchange between the blocks of a cluster: a value goes into a
// peer's shared memory by st.async, which also counts its 4 bytes off
// the peer's mbarrier (complete_tx). A receiving block's thread 0 arms
// the barrier of each phase with the bytes it expects (arrive.expect_tx,
// the phase's one arrival), and its threads wait for the phase's parity.
// Each block waits for exactly the data it reads: no cluster-wide
// barrier, and no fence over the step's stores to device memory. Thread
// 0 arms a barrier's next phase only after a __syncthreads that follows
// every thread's wait on the phase before: a parity wait cannot tell a
// phase from the one two later, so no phase may complete while a thread
// has yet to see the one before it.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n .reg .pred p;\n WAIT_%=:\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%0], "
      "%1;\n"
      " @!p bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void st_async(unsigned addr, float v,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];" ::"r"(addr),
      "r"(__float_as_uint(v)), "r"(bar)
      : "memory");
}

// The block's gate columns of depth row k, w[q] = RW[k][g n + unit0 + q]
// for its U units q (zero past U or n).
__device__ __forceinline__ void load_row_regs(
    const float* __restrict__ rw, int n, int k, int unit0, int U,
    float4 (&w)[kClusterMaxUnits]) {
#pragma unroll
  for (int q = 0; q < kClusterMaxUnits; ++q) {
    if (q < U && k < n && unit0 + q < n) {
      const float* p = rw + (size_t)k * 4 * n + unit0 + q;
      w[q] = make_float4(__ldg(p), __ldg(p + n), __ldg(p + 2 * n),
                         __ldg(p + 3 * n));
    } else {
      w[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    }
  }
}

// The block's gate columns in shared memory, rw_s[k * rs + u * 4 + g] =
// RW[k][g n + unit0 + u] (zero past n), by cp.async (committed as one
// group): a thread keeps one column c = (g, u) and walks k.
__device__ __forceinline__ void load_cluster_cols(const float* __restrict__ rw,
                                                  int n, int unit0,
                                                  const ClusterShape& s,
                                                  float* rw_s) {
  const int per_row = 4 * s.U, rows_a_pass = kThreads / per_row;
  if (threadIdx.x < rows_a_pass * per_row) {
    const int c = threadIdx.x % per_row, g = c / s.U, u = c % s.U;
    const int gu = unit0 + u, bytes = gu < n ? 4 : 0;
    const float* src = rw + (gu < n ? g * n + gu : 0);
    const size_t src_step = bytes ? (size_t)rows_a_pass * 4 * n : 0;
    float* dst = rw_s + u * 4 + g;
    int k = threadIdx.x / per_row;
    src += bytes ? (size_t)k * 4 * n : 0;
    for (; k < n; k += rows_a_pass) {
      cp_async4(dst + k * s.rs, src, bytes);
      src += src_step;
    }
  }
  cp_async_commit();
}

// h rows [row0, row0 + B) of an [b, n] step into hb[k * B + r] (zero
// past b), by cp.async (committed as one group).
template <int B>
__device__ __forceinline__ void stage_rows(const float* __restrict__ h,
                                           int b, int n, int row0,
                                           float* hb) {
  for (int k = threadIdx.x; k < n; k += kThreads) {
#pragma unroll
    for (int r = 0; r < B; ++r) {
      const bool ok = row0 + r < b;
      cp_async4(hb + k * B + r, ok ? h + (size_t)(row0 + r) * n + k : h,
                ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

template <int B>
__device__ __forceinline__ void load_rows(const float* p, float (&h)[B]) {
  if constexpr (B == 1) {
    h[0] = p[0];
  } else if constexpr (B == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    h[0] = v.x;
    h[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < B; i += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + i);
      h[i] = v.x;
      h[i + 1] = v.y;
      h[i + 2] = v.z;
      h[i + 3] = v.w;
    }
  }
}

// Partial gate sums of the block's B rows: product thread (u, sp) adds
// depth rows [sp dk, (sp+1) dk) of h[k][r] * RW[k][g n + unit0 + u],
// read from the resident columns, into zpart[(sp * B + r) * U + u].
template <int B>
__device__ __forceinline__ void gate_partials_smem(
    const float* h_s, const float* rw_s, int n, int u, int sp,
    const ClusterShape& s, float4* zpart) {
  const int k0 = sp * s.dk, k1 = min(n, k0 + s.dk);
  float acc[B][4] = {};
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float4 w =
        *reinterpret_cast<const float4*>(rw_s + k * s.rs + u * 4);
    float hv[B];
    load_rows<B>(h_s + k * B, hv);
#pragma unroll
    for (int r = 0; r < B; ++r) {
      acc[r][0] = fmaf(hv[r], w.x, acc[r][0]);
      acc[r][1] = fmaf(hv[r], w.y, acc[r][1]);
      acc[r][2] = fmaf(hv[r], w.z, acc[r][2]);
      acc[r][3] = fmaf(hv[r], w.w, acc[r][3]);
    }
  }
#pragma unroll
  for (int r = 0; r < B; ++r)
    zpart[(sp * B + r) * s.U + u] =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
}

// The owner's pre-activations: its partial sums in split order, then
// xproj (the grid route's order: x + h @ RW).
template <int B>
__device__ __forceinline__ float4 owner_preacts(const float4* zpart,
                                                const ClusterShape& s, int r,
                                                int u, float4 x) {
  float4 z = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
  for (int sp = 0; sp < s.KS; ++sp) {
    const float4 p = zpart[(sp * B + r) * s.U + u];
    z.x += p.x;
    z.y += p.y;
    z.z += p.z;
    z.w += p.w;
  }
  return make_float4(x.x + z.x, x.y + z.y, x.z + z.z, x.w + z.w);
}

// xproj[t][row][g n + unit] for g = i, f, o, g
__device__ __forceinline__ float4 load_x(const float* __restrict__ xproj,
                                         int t, int b, int n, int row,
                                         int unit) {
  const float* p = xproj + ((size_t)t * b + row) * 4 * n + unit;
  return make_float4(__ldg(p), __ldg(p + n), __ldg(p + 2 * n),
                     __ldg(p + 3 * n));
}

template <int B>
__global__ void __launch_bounds__(kThreads)
    lstm_seq_fwd_cluster_kernel(const float* __restrict__ xproj,
                                const float* __restrict__ rw,
                                const float* __restrict__ h0,
                                const float* __restrict__ c0,
                                float* __restrict__ hseq,
                                float* __restrict__ cseq,
                                float* __restrict__ hT,
                                float* __restrict__ cT, int T, int b, int n) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long mbar[2];  // h_t arrives in buffer (t+1) & 1
  const int C = (int)cluster_blocks(), rank = (int)cluster_rank();
  const ClusterShape s = cluster_shape(n, C);
  const int hsz = n * B;
  float* rw_s = reinterpret_cast<float*>(smem4);  // n x rs
  float* h_s = rw_s + n * s.rs;                   // [2][n][B]
  float4* zpart = reinterpret_cast<float4*>(h_s + round4(2 * hsz));
  const int row0 = (int)(blockIdx.x / C) * B, unit0 = rank * s.U;
  load_cluster_cols(rw, n, unit0, s, rw_s);
  stage_rows<B>(h0, b, n, row0, h_s);
  // product thread (pu, psp) of the gate product
  const bool prod = threadIdx.x < s.U * s.KS;
  const int pu = threadIdx.x % s.U, psp = threadIdx.x / s.U;
  // owner thread of (row r, unit u): its c carry in a register
  const bool owner = threadIdx.x < B * s.U;
  const int r = owner ? threadIdx.x / s.U : 0, u = threadIdx.x % s.U;
  const int row = row0 + r, unit = unit0 + u;
  const bool valid = owner && row < b && unit < n;
  const size_t o = (size_t)row * n + unit, bn = (size_t)b * n;
  float c = valid ? c0[o] : 0.0f;
  float4 x = valid ? load_x(xproj, 0, b, n, row, unit)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  // every block sends h_t (t <= T - 2) to every block: n x B floats in
  // (every block owns a unit, so every block sends)
  const unsigned bytes = (unsigned)(n * B * 4);
  if (threadIdx.x == 0) {
    mbar_init(&mbar[0]);
    mbar_init(&mbar[1]);
    mbar_init_fence();
    if (T >= 2) mbar_expect(&mbar[1], bytes);  // h_0
    if (T >= 3) mbar_expect(&mbar[0], bytes);  // h_1
  }
  cp_async_wait<0>();
  __syncthreads();
  cluster_sync();
  unsigned phase = 0;  // bit p: the parity of mbar[p]'s next phase
  for (int t = 0; t < T; ++t) {
    const int p = t & 1;  // h_{t-1} is in buffer p
    if (t >= 1) {
      mbar_wait(&mbar[p], (phase >> p) & 1u);
      phase ^= 1u << p;
    }
    if (prod)
      gate_partials_smem<B>(h_s + p * hsz, rw_s, n, pu, psp, s, zpart);
    __syncthreads();
    // every thread has passed the wait: mbar[p]'s next phase, h_{t+1}
    if (threadIdx.x == 0 && t >= 1 && t + 1 <= T - 2)
      mbar_expect(&mbar[p], bytes);
    float hn = 0.0f;
    if (owner) {
      const float4 z = owner_preacts<B>(zpart, s, r, u, x);
      const float ig = sigmoid(z.x), fg = sigmoid(z.y);
      const float og = sigmoid(z.z), gg = tanhf(z.w);
      c = fg * c + ig * gg;
      hn = og * tanhf(c);
      if (t + 1 < T && unit < n) {
        // h_t into buffer (t+1) & 1 of every block of the cluster
        const float* dst = h_s + ((t + 1) & 1) * hsz + unit * B + r;
        const unsigned long long* bar = &mbar[(t + 1) & 1];
        const float hv = row < b ? hn : 0.0f;
        for (int p = 0; p < C; ++p)
          st_async(peer_addr(dst, p), hv, peer_addr(bar, p));
      }
    }
    if (valid) {
      hseq[(size_t)t * bn + o] = hn;
      if (cseq != nullptr) cseq[(size_t)t * bn + o] = c;
      if (t == T - 1) {
        hT[o] = hn;
        cT[o] = c;
      }
      if (t + 1 < T) x = load_x(xproj, t + 1, b, n, row, unit);
    }
  }
}

// What the backward's owner reads of step t, fetched a step ahead.
struct BwdStepIn {
  float c_prev, c_t, dh_t;
};

__device__ __forceinline__ BwdStepIn load_bwd_step(
    const float* __restrict__ cprev, const float* __restrict__ cseq,
    const float* __restrict__ dhseq, int t, size_t bn, size_t o) {
  const size_t ot = (size_t)t * bn + o;
  return {__ldg(cprev + ot), __ldg(cseq + ot), __ldg(dhseq + ot)};
}

template <int B>
__global__ void __launch_bounds__(kThreads)
    lstm_seq_bwd_cluster_kernel(const float* __restrict__ xproj,
                                const float* __restrict__ hprev,
                                const float* __restrict__ cprev,
                                const float* __restrict__ cseq,
                                const float* __restrict__ rw,
                                const float* __restrict__ dhseq,
                                const float* __restrict__ dhT,
                                const float* __restrict__ dcT,
                                float* __restrict__ dgates,
                                float* __restrict__ dh0,
                                float* __restrict__ dc0, int T, int b, int n) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long mbar[2];  // step t's partials: buffer t & 1
  const int C = (int)cluster_blocks(), rank = (int)cluster_rank();
  const ClusterShape s = cluster_shape(n, C);
  const int hsz = n * B, dsz = C * B * s.U;
  float* rw_s = reinterpret_cast<float*>(smem4);  // n x rs
  float* hbuf = rw_s + n * s.rs;                  // [2][n][B]
  float4* zpart = reinterpret_cast<float4*>(hbuf + round4(2 * hsz));
  float4* dz_s = zpart + s.KS * B * s.U;                  // [B][U]
  float* dhp = reinterpret_cast<float*>(dz_s + B * s.U);  // [2][C][B][U]
  const int row0 = (int)(blockIdx.x / C) * B, unit0 = rank * s.U;
  const size_t bn = (size_t)b * n;
  load_cluster_cols(rw, n, unit0, s, rw_s);
  stage_rows<B>(hprev + (size_t)(T - 1) * bn, b, n, row0,
                hbuf + ((T - 1) & 1) * hsz);
  // dh product thread k: depth row k of the block's gate columns in
  // registers for all T steps
  const int k = threadIdx.x;
  float4 wr[kClusterMaxUnits];
  load_row_regs(rw, n, k, unit0, s.U, wr);
  // gate recompute thread (pu, psp), as the forward's product, from the
  // resident columns
  const bool prod = threadIdx.x < s.U * s.KS;
  const int pu = threadIdx.x % s.U, psp = threadIdx.x / s.U;
  // owner thread of (row r, unit u): the dh / dc carries in registers,
  // and the gates of its step
  const bool owner = threadIdx.x < B * s.U;
  const int r = owner ? threadIdx.x / s.U : 0, u = threadIdx.x % s.U;
  const int row = row0 + r, unit = unit0 + u;
  const bool valid = owner && row < b && unit < n;
  const size_t o = (size_t)row * n + unit;
  float dh = valid ? dhT[o] : 0.0f, dc = valid ? dcT[o] : 0.0f;
  float4 x = valid ? load_x(xproj, T - 1, b, n, row, unit)
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  BwdStepIn cur = {0.0f, 0.0f, 0.0f}, nxt = {0.0f, 0.0f, 0.0f};
  if (valid) cur = load_bwd_step(cprev, cseq, dhseq, T - 1, bn, o);
  // every block sends its partials for this block's valid units each
  // step: C x B x units floats in
  const int units = min(s.U, n - unit0);
  const unsigned bytes = (unsigned)(C * B * units * 4);
  if (threadIdx.x == 0) {
    mbar_init(&mbar[0]);
    mbar_init(&mbar[1]);
    mbar_init_fence();
    mbar_expect(&mbar[(T - 1) & 1], bytes);  // step T-1's partials
    if (T >= 2) mbar_expect(&mbar[(T - 2) & 1], bytes);
  }
  cp_async_wait<0>();
  __syncthreads();
  if (T >= 2)
    stage_rows<B>(hprev + (size_t)(T - 2) * bn, b, n, row0,
                  hbuf + ((T - 2) & 1) * hsz);
  if (prod)
    gate_partials_smem<B>(hbuf + ((T - 1) & 1) * hsz, rw_s, n, pu, psp, s,
                          zpart);
  __syncthreads();
  float ig = 0.0f, fg = 0.0f, og = 0.0f, gg = 0.0f;
  if (owner) {
    const float4 z = owner_preacts<B>(zpart, s, r, u, x);
    ig = sigmoid(z.x);
    fg = sigmoid(z.y);
    og = sigmoid(z.z);
    gg = tanhf(z.w);
    if (valid && T >= 2) {
      x = load_x(xproj, T - 2, b, n, row, unit);
      nxt = load_bwd_step(cprev, cseq, dhseq, T - 2, bn, o);
    }
  }
  cluster_sync();
  unsigned phase = 0;  // bit p: the parity of mbar[p]'s next phase
  for (int t = T - 1; t >= 0; --t) {
    const int p = (t + 1) & 1;  // step t+1's partials: dh_t
    if (t < T - 1) {
      mbar_wait(&mbar[p], (phase >> p) & 1u);
      phase ^= 1u << p;
      if (owner) {
        const float* q = dhp + p * dsz + r * s.U + u;
        float sum = 0.0f;
        for (int j = 0; j < C; ++j) sum += q[j * B * s.U];
        dh = sum;
      }
    }
    float4 dz = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (valid) {
      // deeplearning4j_tpu/ops/lstm_cell.py:247-255
      const float tc = tanhf(cur.c_t);
      const float dht = cur.dh_t + dh;
      const float d_o = dht * tc;
      const float dct = dht * og * (1.0f - tc * tc) + dc;
      dz.z = d_o * og * (1.0f - og);
      dz.y = (dct * cur.c_prev) * fg * (1.0f - fg);
      dz.x = (dct * gg) * ig * (1.0f - ig);
      dz.w = (dct * ig) * (1.0f - gg * gg);
      dc = dct * fg;
    }
    if (owner) dz_s[r * s.U + u] = dz;
    __syncthreads();
    // every thread has passed the wait: mbar[p]'s next phase, step t-1's
    if (threadIdx.x == 0 && t < T - 1 && t >= 1) mbar_expect(&mbar[p], bytes);
    // partial dh_{t-1}[i][k] over the block's columns, sent to the block
    // that owns unit k
    if (k < n) {
      float acc[B] = {};
#pragma unroll
      for (int q = 0; q < kClusterMaxUnits; ++q) {
        if (q < s.U) {
#pragma unroll
          for (int i = 0; i < B; ++i) {
            const float4 d = dz_s[i * s.U + q];
            acc[i] = fmaf(d.x, wr[q].x, acc[i]);
            acc[i] = fmaf(d.y, wr[q].y, acc[i]);
            acc[i] = fmaf(d.z, wr[q].z, acc[i]);
            acc[i] = fmaf(d.w, wr[q].w, acc[i]);
          }
        }
      }
      const int dest = k / s.U, lu = k - dest * s.U;
      const unsigned dst = peer_addr(
          dhp + (t & 1) * dsz + rank * B * s.U + lu, (unsigned)dest);
      const unsigned bar = peer_addr(&mbar[t & 1], (unsigned)dest);
#pragma unroll
      for (int i = 0; i < B; ++i) st_async(dst + 4u * i * s.U, acc[i], bar);
    }
    if (valid) {
      float* dg = dgates + ((size_t)t * b + row) * 4 * n + unit;
      dg[0] = dz.x;
      dg[n] = dz.y;
      dg[2 * n] = dz.z;
      dg[3 * n] = dz.w;
    }
    if (t > 0) {
      // the gates of step t-1, while step t's partials are in flight
      cur = nxt;
      cp_async_wait<0>();
      __syncthreads();  // hprev[t-1] staged; hbuf[t & 1] free
      if (t >= 2)
        stage_rows<B>(hprev + (size_t)(t - 2) * bn, b, n, row0,
                      hbuf + (t & 1) * hsz);
      if (prod)
        gate_partials_smem<B>(hbuf + ((t - 1) & 1) * hsz, rw_s, n, pu, psp,
                              s, zpart);
      __syncthreads();
      if (owner) {
        const float4 z = owner_preacts<B>(zpart, s, r, u, x);
        ig = sigmoid(z.x);
        fg = sigmoid(z.y);
        og = sigmoid(z.z);
        gg = tanhf(z.w);
        if (valid && t >= 2) {
          x = load_x(xproj, t - 2, b, n, row, unit);
          nxt = load_bwd_step(cprev, cseq, dhseq, t - 2, bn, o);
        }
      }
    }
  }
  mbar_wait(&mbar[0], phase & 1u);  // step 0's partials: dh_{-1}
  if (valid) {
    const float* q = dhp + r * s.U + u;
    float sum = 0.0f;
    for (int j = 0; j < C; ++j) sum += q[j * B * s.U];
    dh0[o] = sum;
    dc0[o] = dc;
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

template <int B>
const void* cluster_kernel_for(bool bwd) {
  return bwd ? (const void*)lstm_seq_bwd_cluster_kernel<B>
             : (const void*)lstm_seq_fwd_cluster_kernel<B>;
}

// rows a cluster: 1, 2, 4 or 8 (index 0..3), else -1
int rows_index(int rows) {
  return rows == 1 ? 0 : rows == 2 ? 1 : rows == 4 ? 2 : rows == 8 ? 3 : -1;
}

const void* pick_cluster_kernel(bool bwd, int rows) {
  switch (rows) {
    case 1:
      return cluster_kernel_for<1>(bwd);
    case 2:
      return cluster_kernel_for<2>(bwd);
    case 4:
      return cluster_kernel_for<4>(bwd);
    default:
      return cluster_kernel_for<8>(bwd);
  }
}

// A cluster launch as the wrapper planned it (C blocks a cluster, `rows`
// batch rows a cluster): the kernel, its shared memory and the launch
// configuration with its cluster dimension. The plan is checked, never
// changed: a plan the kernels do not take is an error.
struct ClusterLaunch {
  const void* fn;
  int smem;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
};

int cluster_setup(bool bwd, int b, int n, int C, int rows,
                  cudaStream_t stream, ClusterLaunch* L) {
  if (C < 1 || C > kClusterMaxBlocks || rows_index(rows) < 0)
    return (int)cudaErrorInvalidValue;
  const ClusterShape s = cluster_shape(n, C);
  // every block owns a unit: an empty block would send nothing (forward)
  // or expect nothing (backward), and fall out of step with its peers
  if (s.U > kClusterMaxUnits || rows * s.U > kThreads || n > kThreads ||
      s.U * s.KS > kThreads || (C - 1) * s.U >= n)
    return (int)cudaErrorInvalidValue;
  L->fn = pick_cluster_kernel(bwd, rows);
  L->smem = cluster_smem_floats(bwd, n, C, rows) * (int)sizeof(float);
  if (L->smem > kClusterSmemCap) return (int)cudaErrorInvalidValue;
  static unsigned done[2][4];
  const int rc = allow_dynamic_smem(L->fn, kClusterSmemCap,
                                    &done[bwd ? 1 : 0][rows_index(rows)]);
  if (rc != 0) return rc;
  L->cfg = cudaLaunchConfig_t{};
  L->cfg.gridDim = dim3((unsigned)(((b + rows - 1) / rows) * C));
  L->cfg.blockDim = dim3(kThreads);
  L->cfg.dynamicSmemBytes = (size_t)L->smem;
  L->cfg.stream = stream;
  L->attr.id = cudaLaunchAttributeClusterDimension;
  L->attr.val.clusterDim.x = (unsigned)C;
  L->attr.val.clusterDim.y = 1;
  L->attr.val.clusterDim.z = 1;
  L->cfg.attrs = &L->attr;
  L->cfg.numAttrs = 1;
  return 0;
}

// Clusters of this launch's shape the card holds at once (0: none).
int active_clusters(const ClusterLaunch& L, int* active) {
  *active = 0;
  return (int)cudaOccupancyMaxActiveClusters(active, L.fn, &L.cfg);
}

int launch_cluster(bool bwd, int b, int n, int C, int rows, void** args,
                   cudaStream_t stream) {
  ClusterLaunch L;
  int rc = cluster_setup(bwd, b, n, C, rows, stream, &L);
  if (rc != 0) return rc;
  // the card must schedule one such cluster; checked once per (device,
  // kernel, n, C), since the answer depends on nothing else
  static long long verified[2][4];
  int dev = 0;
  rc = (int)cudaGetDevice(&dev);
  if (rc != 0) return rc;
  const long long key = ((long long)dev << 40) | ((long long)n << 8) | C;
  long long* slot = &verified[bwd ? 1 : 0][rows_index(rows)];
  if (__atomic_load_n(slot, __ATOMIC_ACQUIRE) != key) {
    int active = 0;
    rc = active_clusters(L, &active);
    if (rc != 0) return rc;
    if (active <= 0) return (int)cudaErrorLaunchOutOfResources;
    __atomic_store_n(slot, key, __ATOMIC_RELEASE);
  }
  rc = (int)cudaLaunchKernelExC(&L.cfg, L.fn, args);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace dl4j

// The grid route's launch plan for a (b, n): writes the grid size and
// whether RW's columns are resident (1) or streamed (0); returns a CUDA
// error code.
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

// A cluster plan (C blocks a cluster, `rows` batch rows a cluster) at
// (b, n): writes one block's dynamic shared memory in bytes and the
// clusters of that shape the card holds at once; returns a CUDA error
// code (the plan is one the kernels do not take, or the card refuses it).
extern "C" int dl4j_lstm_cluster_plan(int bwd, int b, int n, int cluster,
                                      int rows, int* smem_bytes,
                                      int* max_active) {
  if (b <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  dl4j::ClusterLaunch L;
  int rc = dl4j::cluster_setup(bwd != 0, b, n, cluster, rows, nullptr, &L);
  if (rc != 0) return rc;
  *smem_bytes = L.smem;
  return dl4j::active_clusters(L, max_active);
}

// cseq may be null (the inference variant). cluster > 0: the cluster
// route with `cluster` blocks a cluster and `rows` batch rows a cluster
// (barrier unused, may be null); cluster 0: the grid route, whose
// barrier is two zeroed unsigned ints of device memory used by this
// launch alone.
extern "C" int dl4j_lstm_seq_fwd(const float* xproj, const float* rw,
                                 const float* h0, const float* c0,
                                 float* hseq, float* cseq, float* hT,
                                 float* cT, unsigned* barrier, int T, int b,
                                 int n, int cluster, int rows, void* stream) {
  if (T <= 0 || b <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    void* args[] = {&xproj, &rw, &h0, &c0, &hseq, &cseq,
                    &hT, &cT, &T, &b, &n};
    return dl4j::launch_cluster(false, b, n, cluster, rows, args, st);
  }
  if (barrier == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&xproj, &rw, &h0, &c0, &hseq, &cseq,
                  &hT, &cT, &barrier, &T, &b, &n};
  return dl4j::launch(false, b, n, args, st);
}

extern "C" int dl4j_lstm_seq_bwd(const float* xproj, const float* hprev,
                                 const float* cprev, const float* cseq,
                                 const float* rw, const float* dhseq,
                                 const float* dhT, const float* dcT,
                                 float* dgates, float* dh0, float* dc0,
                                 unsigned* barrier, int T, int b, int n,
                                 int cluster, int rows, void* stream) {
  if (T <= 0 || b <= 0 || n <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cluster > 0) {
    void* args[] = {&xproj, &hprev, &cprev, &cseq, &rw, &dhseq, &dhT,
                    &dcT, &dgates, &dh0, &dc0, &T, &b, &n};
    return dl4j::launch_cluster(true, b, n, cluster, rows, args, st);
  }
  if (barrier == nullptr) return (int)cudaErrorInvalidValue;
  void* args[] = {&xproj, &hprev, &cprev, &cseq, &rw, &dhseq, &dhT,
                  &dcT, &dgates, &dh0, &dc0, &barrier, &T, &b, &n};
  return dl4j::launch(true, b, n, args, st);
}
