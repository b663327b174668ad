// Flash attention forward: O = softmax(Q K^T * scale [causal]) V for each
// (batch * head) slice, with the online softmax, so the [t, t] score
// matrix never reaches device memory.
//
// Replaces deeplearning4j_tpu/ops/flash_attention.py `_attention_kernel`
// (:32, the schedule with K/V resident in VMEM, t * d <= 8192 * 64) and
// `_attention_kernel_streamed` (:180, K/V streamed block by block above
// that), both reached through `flash_attention` (:92). Semantics kept:
// causal scores above the diagonal are filled with -1e9 (not -inf), the
// running max starts at 2 * -1e9, the denominator is clamped at 1e-20,
// and key tiles wholly after the query tile are skipped. The two TPU
// schedules differ in one thing only: the resident kernel scales q in
// its input dtype (`q * scale` rounds to bf16 for bf16 inputs), the
// streamed one casts q to f32 first. On Hopper K/V are never resident
// (at t 512, d 64, f32, K and V alone take 256 KB, more than a block's
// 227 KB of shared memory), so both schedules are this one kernel
// template, and `kScaleInInput` is the whole difference; each has its
// own C entry and its own launch counter in the wrapper.
//
// Layout: q, k, v, out [bh, t, d] contiguous (the wrapper's [b, h, t, d]
// flattened), one element type for all four (f32, bf16 or f16); scores,
// softmax state and the output sum are f32; the output is cast once.
// Any t >= 1 (ragged tiles are masked here: keys past t get -inf, so
// they weigh exactly 0) and any d <= kMaxD = 128.
//
// What bounds it on an H100: the useful work is 4 * d * (unmasked
// query-key pairs) FLOPs. At the transformer LM's training shape (bh
// 192, t 512, d 64, causal) that is 6.5 GFLOP over 101 MB of q, k, v and
// o: 0.096 ms of FP32 SIMT at 67 TFLOP/s against 0.030 ms of bytes, so
// operations bound it; at the long-context shape (bh 12, t 16384, d 64,
// causal) 412 GFLOP, 6.15 ms. f32 inputs keep FP32 SIMT (TF32 or bf16
// tensor cores would not hold f32 parity with the reference). The first
// version of this kernel (a 4 x 4 score tile and 4 x d/16 output tile a
// thread, scalar shared loads, K/V staged synchronously) issued 8
// four-byte shared loads per 16 FMAs: shared-load issue, not the FMA
// pipe, set its pace (24 TFLOP/s at t 16384).
//
// Design: one block per (bh, 128-row query tile); the query tiles of the
// causal diagonal's far end (the most key tiles) are launched first. The
// block stages its q tile once (scaled, f32), then loops over 64-key
// tiles. A thread (ty, tx) owns query rows ty + 16 i (i < 8), keys tx +
// kTX j of S and columns in runs of 4 at tx of O: at d <= 64, kTX 8 (128
// threads, two blocks an SM), so an 8 x 8 score tile and an 8 x 8 (d 64)
// output tile; at d 128, kTX 16 (256 threads), 8 x 4 scores and 8 x 8
// outputs. Every operand is read along d (or along the keys) as a
// 16-byte shared load, and a 16-byte load costs the shared-memory pipe
// four cycles whatever it fetches, so the tile sets the pace: at d 64 S
// = Q K^T takes 8 q and 8 k loads per 4 steps of d for 256 FMAs, O += P
// V 8 p and 8 v loads per 4 keys for 256 FMAs, one load cycle per 4 FMA
// cycles, the FMA pipe's own rate (the first 256-thread 8 x 4 version of
// this body issued 12 loads per 128 FMAs and ran at 32 TFLOP/s). K rows
// are padded by 16 bytes, so the 8 lanes of a quarter warp (8 keys) hit 8
// distinct bank quads; q and p reads are broadcasts within a quarter
// warp, v reads consecutive. The row max and row sum run over the kTX
// lanes that share ty (warp shuffles), P goes through shared memory. K
// and V tiles arrive by 16-byte cp.async in their input type (widened to
// f32 when read) through a ring of Layout::kStages stages. With two,
// tile j + 1 loads while tile j runs; where two do not fit the blocks an
// SM is meant to hold (f32 at d 64: 139,264 bytes a block against two
// blocks' 115,712 each; f32 at d 128: 237,568) one K and one V buffer
// are refilled in turn, K for the next tile while this tile's softmax
// and P V run, V while the next tile's S runs. A shape whose rows are
// not 16-byte multiples (d not a multiple of 16 bytes' worth of
// elements) stages synchronously through registers. Every sum runs in a
// fixed order: two launches give the same bits. The shared-memory
// reckoning is ops/flash_attention.py `flash_smem_plan`.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 128;        // query rows of a block
constexpr int kBK = 64;         // keys of a tile
constexpr int kRowGroups = 16;  // query rows ty + 16 i of a thread
constexpr int kRows = kBQ / kRowGroups;  // 8
constexpr int kMaxD = 128;
constexpr float kNeg = -1e9f;  // the reference's masked-score fill
constexpr int kQS = 4;         // f32 padding of q and p rows
constexpr int kPS = kBK + kQS;
constexpr int kSmSmemBytes = 233472;  // an SM's shared memory for blocks

// Thread layout and shared memory for element type T at padded head
// dimension DP. A thread owns 8 query rows and kTX-strided keys of S and
// columns of O: 8 x 8 tiles (kTX 8, 128 threads) at d <= 64, 8 x 4
// scores and 8 x 8 outputs (kTX 16, 256 threads) at d 128. Shared
// memory: q_s [kBQ][DP + 4] f32, p_s [kBQ][kBK + 4] f32, then the K/V
// ring: kStages x (K tile, V tile), each [kBK][DP + 16 bytes] of T. Two
// stages where the blocks an SM is meant to hold (two of 128 threads,
// one of 256) still fit, else one.
template <typename T, int DP>
struct Layout {
  static constexpr int kTX = DP == 128 ? 16 : 8;
  static constexpr int kThreads = kRowGroups * kTX;
  static constexpr int kMinBlocks = kThreads == 128 ? 2 : 1;
  static constexpr int kKeys = kBK / kTX;  // keys of S a thread owns
  static constexpr int kKS = DP + 16 / (int)sizeof(T);  // K / V row (T)
  static constexpr int kQBytes = kBQ * (DP + kQS) * 4;
  static constexpr int kPBytes = kBQ * kPS * 4;
  static constexpr int kTileBytes = kBK * kKS * (int)sizeof(T);
  static constexpr int kBudget =
      kMinBlocks == 1 ? dl4j::kMaxSmemBytes : kSmSmemBytes / 2 - 1024;
  static constexpr int kStages =
      kQBytes + kPBytes + 4 * kTileBytes <= kBudget ? 2 : 1;
  static constexpr int kBytes = kQBytes + kPBytes + 2 * kStages * kTileBytes;
};

// four consecutive elements of shared memory, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ float4 load4(const __half* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&raw.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
// two consecutive elements, widened to f32
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const __half* p) {
  return __half22float2(*reinterpret_cast<const __half2*>(p));
}

// Stage rows [k0, k0 + kBK) of one [t, d] slice into a [kBK][kKS] tile
// of T: 16-byte cp.async copies when `vec` (rows of whole 16-byte
// chunks, 16-byte aligned), rows past t zero-filled; otherwise plain
// loads and stores (complete at the caller's next barrier). Columns
// d..DP-1 are never written (zeroed once at the kernel's start).
template <typename T, int DP>
__device__ __forceinline__ void stage_tile(const T* __restrict__ src, int t,
                                           int d, int k0, bool vec, T* dst) {
  constexpr int kKS = Layout<T, DP>::kKS;
  constexpr int kThreads = Layout<T, DP>::kThreads;
  const int tid = threadIdx.x;
  if (vec) {
    constexpr int kPer = 16 / (int)sizeof(T);  // elements a chunk
    const int chunks = d / kPer;               // a row's chunks
    for (int idx = tid; idx < kBK * chunks; idx += kThreads) {
      const int r = idx / chunks, c = (idx - r * chunks) * kPer;
      const bool ok = k0 + r < t;
      const T* s = src + (size_t)(ok ? k0 + r : 0) * d + c;
      dl4j::cp_async16(dst + r * kKS + c, s, ok ? 16 : 0);
    }
  } else {
    for (int idx = tid; idx < kBK * d; idx += kThreads) {
      const int r = idx / d, c = idx - r * d;
      dst[r * kKS + c] = k0 + r < t ? src[(size_t)(k0 + r) * d + c]
                                    : dl4j::from_f32<T>(0.0f);
    }
  }
}

template <typename T, int DP, bool kScaleInInput>
__global__ void __launch_bounds__(Layout<T, DP>::kThreads,
                                  Layout<T, DP>::kMinBlocks)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int bh,
                     int t, int d, int n_qtiles, int causal, float scale,
                     int vec) {
  using L = Layout<T, DP>;
  constexpr int kTX = L::kTX;
  constexpr int kThreads = L::kThreads;
  constexpr int kKeys = L::kKeys;
  constexpr int kKS = L::kKS;
  constexpr int kStages = L::kStages;
  constexpr int kQRow = DP + kQS;
  // output columns a thread owns: kChunks runs of kCW consecutive ones
  constexpr int kCols = DP / kTX;
  constexpr int kCW = kCols < 4 ? kCols : 4;
  constexpr int kChunks = kCols / kCW;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* q_s = reinterpret_cast<float*>(smem_raw);
  float* p_s = q_s + kBQ * kQRow;
  T* kv_s = reinterpret_cast<T*>(p_s + kBQ * kPS);
  // stage s: K tile at kv_s + 2 s tile, V tile right after it
  constexpr int kTile = kBK * kKS;

  const int slice = blockIdx.x % bh;
  const int qt = n_qtiles - 1 - blockIdx.x / bh;  // heaviest tiles first
  const int q0 = qt * kBQ;
  const size_t base = (size_t)slice * t * d;
  const T* k_src = k + base;
  const T* v_src = v + base;
  const int tid = threadIdx.x;
  const int tx = tid % kTX;  // keys tx + kTX j; column runs of tx
  const int ty = tid / kTX;  // query rows ty + 16 i

  if (d < DP) {  // the padding columns of every K / V buffer read as 0
    for (int i = tid; i < 2 * kStages * kTile; i += kThreads)
      kv_s[i] = dl4j::from_f32<T>(0.0f);
    __syncthreads();  // zeros land before any copy into the buffers
  }

  int n_kt = (t + kBK - 1) / kBK;
  if (causal) {
    // tiles that start after this tile's last query are fully masked
    const int last = min(q0 + kBQ, t) - 1;
    n_kt = min(n_kt, last / kBK + 1);
  }
  // the ring's first tiles go out before q is staged
  stage_tile<T, DP>(k_src, t, d, 0, vec, kv_s);
  dl4j::cp_async_commit();
  stage_tile<T, DP>(v_src, t, d, 0, vec, kv_s + kTile);
  dl4j::cp_async_commit();

  const float scale_in = dl4j::to_f32(dl4j::from_f32<T>(scale));
  for (int idx = tid; idx < kBQ * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float val = 0.0f;
    if (q0 + r < t && c < d) {
      const float raw = dl4j::to_f32(q[base + (size_t)(q0 + r) * d + c]);
      // the resident schedule rounds q * scale to the input dtype
      val = kScaleInInput ? dl4j::to_f32(dl4j::from_f32<T>(raw * scale_in))
                          : raw * scale;
    }
    q_s[r * kQRow + c] = val;
  }

  float m_i[kRows], l_i[kRows], o_acc[kRows][kCols];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m_i[i] = 2.0f * kNeg;
    l_i[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o_acc[i][j] = 0.0f;
  }

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    const int stage = kStages == 2 ? (kt & 1) : 0;
    const T* k_s = kv_s + 2 * stage * kTile;
    const T* v_s = k_s + kTile;
    if (kStages == 2) {
      // tile kt + 1 into the other stage (freed by the last barrier of
      // tile kt - 1), then wait for tile kt
      if (kt + 1 < n_kt) {
        T* nxt = kv_s + 2 * (stage ^ 1) * kTile;
        stage_tile<T, DP>(k_src, t, d, k0 + kBK, vec, nxt);
        stage_tile<T, DP>(v_src, t, d, k0 + kBK, vec, nxt + kTile);
        dl4j::cp_async_commit();
        dl4j::cp_async_wait<1>();
      } else {
        dl4j::cp_async_wait<0>();
      }
    } else {
      dl4j::cp_async_wait<1>();  // K of tile kt (its V may be in flight)
    }
    __syncthreads();

    // S = Q K^T: 8 rows x 4 keys, along d in 16-byte steps
    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.0f;
#pragma unroll 2
    for (int dd = 0; dd < DP; dd += 4) {
      float4 kv[kKeys];
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        kv[j] = load4(k_s + (tx + kTX * j) * kKS + dd);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv = load4(q_s + (ty + 16 * i) * kQRow + dd);
#pragma unroll
        for (int j = 0; j < kKeys; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }
    if (kStages == 1) {
      __syncthreads();  // every thread is done with K: refill it
      if (kt + 1 < n_kt)
        stage_tile<T, DP>(k_src, t, d, k0 + kBK, vec, kv_s);
      dl4j::cp_async_commit();  // (an empty group on the last tile)
    }

    // mask, online softmax over the row's 64 keys (kTX lanes), P to
    // shared memory
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const int key = k0 + tx + kTX * j;
        if (key >= t) {
          s[i][j] = -INFINITY;  // past the sequence: weighs exactly 0
        } else if (causal && key > row) {
          s[i][j] = kNeg;
        }
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.0f;
      float* p_row = p_s + (ty + 16 * i) * kPS + tx;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_row[kTX * j] = p;
      }
#pragma unroll
      for (int off = kTX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < kCols; ++j) o_acc[i][j] *= corr;
      m_i[i] = m_new;
    }
    if (kStages == 1) {
      // V of tile kt; K of tile kt + 1 may stay in flight
      dl4j::cp_async_wait<1>();
    }
    __syncthreads();  // P complete (and, with one stage, V landed)

    // O += P V: 8 rows x d/kTX columns, 4 keys a step
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float vv[4][kCols];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const T* v_row = v_s + (kk + e) * kKS + tx * kCW;
#pragma unroll
        for (int h = 0; h < kChunks; ++h) {
          if constexpr (kCW == 4) {
            const float4 w = load4(v_row + h * kTX * kCW);
            vv[e][4 * h] = w.x;
            vv[e][4 * h + 1] = w.y;
            vv[e][4 * h + 2] = w.z;
            vv[e][4 * h + 3] = w.w;
          } else {
            const float2 w = load2(v_row + h * kTX * kCW);
            vv[e][2 * h] = w.x;
            vv[e][2 * h + 1] = w.y;
          }
        }
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 p = load4(p_s + (ty + 16 * i) * kPS + kk);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          o_acc[i][j] = fmaf(p.x, vv[0][j], o_acc[i][j]);
          o_acc[i][j] = fmaf(p.y, vv[1][j], o_acc[i][j]);
          o_acc[i][j] = fmaf(p.z, vv[2][j], o_acc[i][j]);
          o_acc[i][j] = fmaf(p.w, vv[3][j], o_acc[i][j]);
        }
      }
    }
    __syncthreads();  // done with P and this stage's V
    if (kStages == 1) {
      if (kt + 1 < n_kt)
        stage_tile<T, DP>(v_src, t, d, k0 + kBK, vec, kv_s + kTile);
      dl4j::cp_async_commit();
    }
  }
  dl4j::cp_async_wait<0>();  // no copy outlives the block

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    const float inv = 1.0f / fmaxf(l_i[i], 1e-20f);
    T* dst = out + base + (size_t)row * d;
#pragma unroll
    for (int h = 0; h < kChunks; ++h)
#pragma unroll
      for (int e = 0; e < kCW; ++e) {
        const int c = h * kTX * kCW + tx * kCW + e;
        if (c < d) dst[c] = dl4j::from_f32<T>(o_acc[i][h * kCW + e] * inv);
      }
  }
}

template <typename T, int DP, bool kScaleInInput>
int launch_dp(const void* q, const void* k, const void* v, void* out,
              int bh, int t, int d, int causal, float scale,
              cudaStream_t stream) {
  constexpr int smem = Layout<T, DP>::kBytes;
  static_assert(smem <= dl4j::kMaxSmemBytes, "flash tile over 227 KB");
  static unsigned smem_set = 0;  // devices whose cap is raised
  const int rc = dl4j::allow_dynamic_smem(
      flash_fwd_kernel<T, DP, kScaleInInput>, smem, &smem_set);
  if (rc != 0) return rc;
  const int n_qtiles = (t + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qtiles * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  constexpr int kPer = 16 / (int)sizeof(T);
  const int vec = d % kPer == 0 &&
                  (reinterpret_cast<uintptr_t>(k) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(v) & 15) == 0;
  flash_fwd_kernel<T, DP, kScaleInInput><<<(unsigned)blocks,
                                           Layout<T, DP>::kThreads, smem,
                                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bh, t, d, n_qtiles,
      causal, scale, vec);
  return (int)cudaGetLastError();
}

// the head dimension padded to 32, 64 or 128 (zeros past d)
inline int padded_d(int d) { return d <= 32 ? 32 : d <= 64 ? 64 : 128; }

template <typename T, bool kScaleInInput>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int t, int d, int causal, float scale, cudaStream_t stream) {
  switch (padded_d(d)) {
    case 32:
      return launch_dp<T, 32, kScaleInInput>(q, k, v, out, bh, t, d, causal,
                                             scale, stream);
    case 64:
      return launch_dp<T, 64, kScaleInInput>(q, k, v, out, bh, t, d, causal,
                                             scale, stream);
    default:
      return launch_dp<T, 128, kScaleInInput>(q, k, v, out, bh, t, d,
                                              causal, scale, stream);
  }
}

template <bool kScaleInInput>
int dispatch(const void* q, const void* k, const void* v, void* out,
             int dtype, int bh, int t, int d, int causal, float scale,
             void* stream) {
  if (bh <= 0 || t <= 0) return 0;
  if (d <= 0 || d > kMaxD) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dl4j::kF32:
      return launch<float, kScaleInInput>(q, k, v, out, bh, t, d, causal,
                                          scale, st);
    case dl4j::kBF16:
      return launch<__nv_bfloat16, kScaleInInput>(q, k, v, out, bh, t, d,
                                                  causal, scale, st);
    case dl4j::kF16:
      return launch<__half, kScaleInInput>(q, k, v, out, bh, t, d, causal,
                                           scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int plan_of(int d, int* stages) {
  switch (padded_d(d)) {
    case 32:
      *stages = Layout<T, 32>::kStages;
      return Layout<T, 32>::kBytes;
    case 64:
      *stages = Layout<T, 64>::kStages;
      return Layout<T, 64>::kBytes;
    default:
      *stages = Layout<T, 128>::kStages;
      return Layout<T, 128>::kBytes;
  }
}

}  // namespace

// The resident schedule's entry (q scaled in its input dtype). Returns
// the cudaError_t of the launch (0 on success); shapes are validated by
// the Python wrapper (ops/flash_attention.py, whose MAX_HEAD_DIM is
// kMaxD).
extern "C" int dl4j_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int dtype,
                                    int bh, int t, int d, int causal,
                                    float scale, void* stream) {
  return dispatch<true>(q, k, v, out, dtype, bh, t, d, causal, scale,
                        stream);
}

// The streamed schedule's entry (q cast to f32, then scaled).
extern "C" int dl4j_flash_attention_streamed(const void* q, const void* k,
                                             const void* v, void* out,
                                             int dtype, int bh, int t, int d,
                                             int causal, float scale,
                                             void* stream) {
  return dispatch<false>(q, k, v, out, dtype, bh, t, d, causal, scale,
                         stream);
}

// The kernel's shared-memory plan for `dtype` at head dimension d: the
// bytes a block takes, and its K/V stages in *stages (-1 for a dtype or
// d the kernel does not take). ops/flash_attention.py flash_smem_plan
// reckons the same.
extern "C" int dl4j_flash_smem_bytes(int dtype, int d, int* stages) {
  *stages = -1;
  if (d <= 0 || d > kMaxD) return -1;
  switch (dtype) {
    case dl4j::kF32:
      return plan_of<float>(d, stages);
    case dl4j::kBF16:
      return plan_of<__nv_bfloat16>(d, stages);
    case dl4j::kF16:
      return plan_of<__half>(d, stages);
    default:
      return -1;
  }
}
