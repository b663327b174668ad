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
// What bounds it on an H100 at the transformer LM's training shape (bh
// 192, t 512, d 64, causal): the useful work is 2 * 2 * t^2 * d / 2 * bh
// = 6.4 GFLOP (12.9 without the causal skip) over 101 MB for q, k, v
// and o: ~0.096 ms of FP32 SIMT at 67 TFLOP/s against ~0.030 ms of
// bytes at 3.35 TB/s, so operations bound it. At the long-context shape
// (bh 12, t 16384, d 64, causal) it is ~412 GFLOP a layer, ~6.2 ms.
// f32 inputs keep the FP32 SIMT path (TF32 or bf16 tensor cores would
// not hold f32 parity with the reference); bf16 inputs are widened to
// f32 on staging. `wgmma` on bf16, TMA and a warp-specialised pipeline
// are later work.
//
// Design: one block per (bh, 64-row query tile); the query tiles of the
// causal diagonal's far end (the most key tiles) are launched first.
// The block stages its q tile (scaled) once, then loops over 64-key
// tiles: K and V through shared memory, S = Q K^T as a 4 x 4 register
// tile per thread (256 threads cover 64 x 64), the mask, the row max
// and row sum by warp shuffles over the 16 threads that share a row,
// P through shared memory, and O += P V into a register tile (4 rows x
// d/16 columns a thread). A thread's four rows keep their m, l and o in
// registers for the whole loop, so the rescale by exp(m - m_new) needs
// no synchronisation. Every sum runs in a fixed order: two launches
// give the same bits.

#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kBQ = 64;        // query rows of a block
constexpr int kBK = 64;        // keys of a tile
constexpr int kThreads = 256;  // 16 x 16: 4 x 4 score tile a thread
constexpr int kMaxD = 128;
constexpr float kNeg = -1e9f;  // the reference's masked-score fill

// shared-memory strides (floats); odd row strides keep the column walks
// of S = Q K^T and the row reads of P free of bank conflicts
template <int DP>
struct Layout {
  static constexpr int kQS = DP + 1;
  static constexpr int kKS = DP + 1;
  static constexpr int kVS = DP;
  static constexpr int kPS = kBK + 1;
  static constexpr int kFloats =
      kBQ * kQS + kBK * kKS + kBK * kVS + kBQ * kPS;
};

template <typename T, int DP, bool kScaleInInput>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out, int bh,
                     int t, int d, int n_qtiles, int causal, float scale) {
  using L = Layout<DP>;
  constexpr int kCols = DP / 16;  // output columns a thread owns
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + kBQ * L::kQS;
  float* v_s = k_s + kBK * L::kKS;
  float* p_s = v_s + kBK * L::kVS;

  // heaviest query tiles (most unmasked key tiles) first
  const int slice = blockIdx.x % bh;
  const int qt = n_qtiles - 1 - blockIdx.x / bh;
  const int q0 = qt * kBQ;
  const size_t base = (size_t)slice * t * d;
  const int tid = threadIdx.x;
  const int tx = tid % 16;  // key / output-column group
  const int ty = tid / 16;  // query-row group: rows ty + 16 i

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
    q_s[r * L::kQS + c] = val;
  }

  float m_i[4], l_i[4], o_acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_i[i] = 2.0f * kNeg;
    l_i[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) o_acc[i][j] = 0.0f;
  }

  int n_kt = (t + kBK - 1) / kBK;
  if (causal) {
    // tiles that start after this tile's last query are fully masked
    const int last = min(q0 + kBQ, t) - 1;
    n_kt = min(n_kt, last / kBK + 1);
  }
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's readers are done
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int r = idx / DP, c = idx % DP;
      float kv = 0.0f, vv = 0.0f;
      if (k0 + r < t && c < d) {
        const size_t off = base + (size_t)(k0 + r) * d + c;
        kv = dl4j::to_f32(k[off]);
        vv = dl4j::to_f32(v[off]);
      }
      k_s[r * L::kKS + c] = kv;
      v_s[r * L::kVS + c] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int dd = 0; dd < d; ++dd) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = q_s[(ty + 16 * i) * L::kQS + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = k_s[(tx + 16 * j) * L::kKS + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int key = k0 + tx + 16 * j;
        if (key >= t) {
          s[i][j] = -INFINITY;  // past the sequence: weighs exactly 0
        } else if (causal && key > row) {
          s[i][j] = kNeg;
        }
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 64 scores live in the 16 lanes that share ty
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m_i[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        p_s[(ty + 16 * i) * L::kPS + tx + 16 * j] = p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float corr = expf(m_i[i] - m_new);
      l_i[i] = l_i[i] * corr + sum;
#pragma unroll
      for (int j = 0; j < kCols; ++j) o_acc[i][j] *= corr;
      m_i[i] = m_new;
    }
    __syncthreads();  // P complete

    const int kk_end = min(kBK, t - k0);
#pragma unroll 4
    for (int kk = 0; kk < kk_end; ++kk) {
      float pv[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = p_s[(ty + 16 * i) * L::kPS + kk];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = v_s[kk * L::kVS + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          o_acc[i][j] = fmaf(pv[i], vv[j], o_acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= t) continue;
    const float inv = 1.0f / fmaxf(l_i[i], 1e-20f);
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int c = tx + 16 * j;
      if (c < d)
        out[base + (size_t)row * d + c] =
            dl4j::from_f32<T>(o_acc[i][j] * inv);
    }
  }
}

template <typename T, int DP, bool kScaleInInput>
int launch_dp(const void* q, const void* k, const void* v, void* out,
              int bh, int t, int d, int causal, float scale,
              cudaStream_t stream) {
  const size_t smem = sizeof(float) * Layout<DP>::kFloats;
  // above 48 KB only after opting in, once per instantiation (so a
  // launch captured in a CUDA graph makes no attribute call)
  static bool opted_in = false;
  if (!opted_in) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_fwd_kernel<T, DP, kScaleInInput>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    opted_in = true;
  }
  const int n_qtiles = (t + kBQ - 1) / kBQ;
  const long long blocks = (long long)n_qtiles * bh;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_fwd_kernel<T, DP, kScaleInInput><<<(unsigned)blocks, kThreads, smem,
                                           stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), bh, t, d, n_qtiles,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T, bool kScaleInInput>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int t, int d, int causal, float scale, cudaStream_t stream) {
  // the head dimension padded to 32, 64 or 128 (zeros past d)
  if (d <= 32)
    return launch_dp<T, 32, kScaleInInput>(q, k, v, out, bh, t, d, causal,
                                           scale, stream);
  if (d <= 64)
    return launch_dp<T, 64, kScaleInInput>(q, k, v, out, bh, t, d, causal,
                                           scale, stream);
  return launch_dp<T, 128, kScaleInInput>(q, k, v, out, bh, t, d, causal,
                                          scale, stream);
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
