// Fused convolution: out = act((conv2d(x, w)) * scale + shift).
//
// Replaces deeplearning4j_tpu/ops/conv_block.py::_conv_kernel (the
// forward, reached through _direct_conv_call from conv_block).
//
// Layout: x NCHW [n, c, h, w], w OIHW [o, c, kh, kw], scale/shift f32
// [o], out NCHW [n, o, oh, ow]. x and w share one element type (f32,
// bf16 or f16); out is that type or f32 (the backward's recompute of the
// f32 accumulator from half operands, as JAX's _conv_block_bwd asks of
// the TPU kernel); products accumulate in f32 registers and are cast
// once on the store, as the TPU kernel does.
//
// What bounds it on an H100: at the slice's shapes the conv is
// arithmetic-heavy (AlexNet conv2 at batch 64: 57 GFLOP against 68 MB
// moved, about 840 FLOP per byte; LeNet conv2 at batch 32: 102 MFLOP
// against 0.9 MB). With FP32 FMA (no tensor cores: TF32 would not hold
// f32 parity) the floor is the 67 TFLOP/s FP32 rate, so operations,
// not bytes, bound it.
//
// Both routes are an implicit GEMM: the output is a matrix [o,
// n*oh*ow] (pixels flattened over the batch, so LeNet's 8x8 maps still
// fill blocks) and the reduction runs over k = (ci, dh, dw), c*kh*kw
// long; the im2col operand exists only in shared memory, one k slice
// at a time. The wrapper picks the route from the shape alone
// (ops/conv_block.py conv_block_route) and passes it in:
//
// - direct (kRouteDirect): any dtype, any shape. Each block owns a
//   64-channel x 64-pixel output tile and walks k in slices of 16,
//   staged synchronously (padding by bounds checks); 256 threads keep
//   4x4 f32 accumulators, 16 FMAs per 8 shared-memory reads. A small
//   conv has few tiles (LeNet's second conv at the serving bucket of 32:
//   32 tiles for 132 SMs); then the k axis is split over blockIdx.z
//   until about two waves of blocks are in flight (common.cuh
//   plan_splits); each split writes its f32 sums to a scratch and
//   splitk_finish adds them in a fixed order and applies the epilogue,
//   so the result is deterministic. The direct tile is bound by
//   shared-memory issue, not by the FMA rate, and nothing overlaps its
//   loads: AlexNet's convs run at 13-17 TFLOP/s on it (H100 SXM,
//   PERF.md).
//
// - wide (kRouteWide): convs whose grid fills the card (AlexNet's five
//   at batch 64, LeNet-5's at the training batch, ResNet-50's), in any
//   of the three dtypes. A block owns
//   TO = 32*MI output channels x TP = 128*PJ pixels (96 x 256,
//   128 x 128, 96 x 128 or 32 x 256: the wrapper picks the tile with
//   the least wave-quantised work), 256 threads as 8 channel
//   rows x 32 pixel lanes; a thread keeps 4*MI x 4*PJ f32
//   accumulators. Its channels are MI float4 groups (one broadcast
//   shared load each); its pixels are PJ float4 groups (kVecB: 96 x 256
//   and 128 x 128, 5 shared loads for 64-96 FMAs) or 4*PJ lanes 32
//   apart (the narrow tiles, whose small depths make the epilogue count:
//   its stores then run along the pixel axis, contiguous within an
//   image in NCHW). A 4-stage ring of 16-deep k slices is filled with
//   cp.async, one barrier a slice, so three slices load while one
//   computes: the weights, transposed once a call into a zero-padded
//   [k_pad, o_pad] matrix (prep kernel below), in 16-byte copies with
//   no masks; the im2col slice gathered in 4-byte copies, the padding
//   zero-filled (src-size 0) so no branch reaches shared memory (a half
//   image is loaded, converted to f32 and stored instead: the ring is
//   f32 in every dtype, and those loads are not overlapped). The
//   gather's addresses come from a per-shape tap table k -> (ci*h*w +
//   dh*w + dw, dh, dw) (ops/conv_block.py conv_tap_table, copied into
//   shared memory once a block), so the main loop does no integer
//   division; each stager thread owns one pixel for the whole loop. No
//   atomics and no split: bitwise repeatable.
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kOcBlock = 64;   // output channels per block
constexpr int kPxBlock = 64;   // output pixels (over n*oh*ow) per block
constexpr int kKSlice = 16;    // reduction slice staged per iteration
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T, typename TO>
__global__ void __launch_bounds__(kThreads)
    conv_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, TO* __restrict__ out,
                      float* __restrict__ partial, int n, int c, int h,
                      int wd, int o, int kh, int kw, int sh, int sw, int ph,
                      int pw, int oh, int ow, int k_chunk, int act) {
  __shared__ float w_s[kKSlice][kOcBlock + 4];
  __shared__ float x_s[kKSlice][kPxBlock];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // pixel group of this thread's outputs
  const int ty = tid / 16;  // channel group of this thread's outputs
  const int px0 = blockIdx.x * kPxBlock;
  const int oc0 = blockIdx.y * kOcBlock;
  const int khw = kh * kw;
  const int k_len = c * khw;
  const int ohw = oh * ow;
  const int n_px = n * ohw;
  // this block's k chunk (all of k unless split-K)
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(k_len, k_lo + k_chunk);

  // input stager: one pixel column per thread, rows lk, lk+4, ...
  const int lp = tid % kPxBlock;
  const int lk = tid / kPxBlock;
  const int gp = px0 + lp;
  const bool px_ok = gp < n_px;
  int iy0 = 0, ix0 = 0;
  const T* x_img = x;
  if (px_ok) {
    const int img = gp / ohw;
    const int r = gp - img * ohw;
    const int oy = r / ow;
    const int ox = r - oy * ow;
    iy0 = oy * sh - ph;
    ix0 = ox * sw - pw;
    x_img = x + (size_t)img * c * h * wd;
  }
  // weight stager: one k column per thread, channel rows wo, wo+16, ...
  const int wk = tid % kKSlice;
  const int wo = tid / kKSlice;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kKSlice) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int oc = wo + 16 * i;
      const int k = k0 + wk;
      float v = 0.0f;
      if (oc0 + oc < o && k < k_hi)
        v = dl4j::to_f32(w[(size_t)(oc0 + oc) * k_len + k]);
      w_s[wk][oc] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = lk + 4 * i;
      const int k = k0 + kk;
      float v = 0.0f;
      if (px_ok && k < k_hi) {
        const int ci = k / khw;
        const int r = k - ci * khw;
        const int dh = r / kw;
        const int dw = r - dh * kw;
        const int iy = iy0 + dh;
        const int ix = ix0 + dw;
        if (iy >= 0 && iy < h && ix >= 0 && ix < wd)
          v = dl4j::to_f32(x_img[((size_t)ci * h + iy) * wd + ix]);
      }
      x_s[kk][lp] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKSlice; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = w_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = x_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int oc = oc0 + ty + 16 * i;
    if (oc >= o) continue;
    const float s = scale[oc];
    const float t = shift[oc];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = px0 + tx + 16 * j;
      if (p >= n_px) continue;
      const int img = p / ohw;
      const int r = p - img * ohw;
      const size_t idx = ((size_t)img * o + oc) * ohw + r;
      if (partial != nullptr) {
        partial[(size_t)blockIdx.z * n_px * o + idx] = acc[i][j];
      } else {
        const float z = dl4j::apply_act(acc[i][j] * s + t, act);
        out[idx] = dl4j::from_f32<TO>(z);
      }
    }
  }
}

long long tiles(int n, int o, int oh, int ow) {
  const long long n_px = (long long)n * oh * ow;
  return ((n_px + kPxBlock - 1) / kPxBlock) * dl4j::ceil_div(o, kOcBlock);
}

template <typename T, typename TO>
int launch(const void* x, const void* w, const float* scale,
           const float* shift, void* out, float* partial, int n, int c,
           int h, int wd, int o, int kh, int kw, int sh, int sw, int ph,
           int pw, int oh, int ow, int act, int splits, cudaStream_t stream) {
  const long long n_px = (long long)n * oh * ow;
  const long long px_blocks = (n_px + kPxBlock - 1) / kPxBlock;
  const int oc_blocks = dl4j::ceil_div(o, kOcBlock);
  if (px_blocks > 0x7fffffffLL || oc_blocks > 65535)
    return (int)cudaErrorInvalidValue;
  const int k_len = c * kh * kw;
  int k_chunk = k_len;
  int z = 1;
  if (splits > 1) {
    if (partial == nullptr || k_len <= 0) return (int)cudaErrorInvalidValue;
    k_chunk = dl4j::k_chunk_for(k_len, splits);
    z = dl4j::ceil_div(k_len, k_chunk);
    if (z > splits) return (int)cudaErrorInvalidValue;
  }
  dim3 grid((unsigned)px_blocks, (unsigned)oc_blocks, (unsigned)z);
  conv_block_kernel<T, TO><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, shift,
      static_cast<TO*>(out), z > 1 ? partial : nullptr, n, c, h, wd, o, kh,
      kw, sh, sw, ph, pw, oh, ow, k_chunk, act);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || z == 1) return rc;
  return dl4j::launch_splitk_finish<TO>(partial, z, n_px * o, scale, shift,
                                        (long long)oh * ow, o, act,
                                        static_cast<TO*>(out), stream);
}

// --- the wide route ---------------------------------------------------------

// route codes shared with ops/conv_block.py (ROUTE_CODES)
enum Route { kRouteDirect = 0, kRouteWide = 1 };

namespace wide {
constexpr int kThreads = 256;  // 8 channel rows x 32 pixel lanes
constexpr int kK = 16;         // k slice per stage
constexpr int kStages = 4;     // ring depth
// marks a tap-table entry past k_len: dh this large fails every bounds
// check (the wrapper keeps h + padding below it)
constexpr int kPadTap = 0x7fff;
}  // namespace wide

// A wide tile: TO = 32*MI output channels x TP = 128*PJ pixels.
template <int MI, int PJ>
struct WideTile {
  static constexpr int kTO = 32 * MI;
  static constexpr int kTP = 128 * PJ;
  static constexpr int kWFloats = wide::kK * kTO;  // w_s[k][oc]
  static constexpr int kXFloats = wide::kK * kTP;  // x_s[k][px]
  static constexpr int kStageFloats = kWFloats + kXFloats;
  static constexpr int kRingBytes = wide::kStages * kStageFloats * 4;
};

// Dynamic shared memory of a wide block: the ring, then the tap table
// (k_pad int2 entries). The formula of ops/conv_block.py
// conv_wide_smem_bytes.
template <int MI, int PJ>
int wide_smem_bytes(int k_pad) {
  return WideTile<MI, PJ>::kRingBytes + k_pad * 8;
}

// wt[k][oc] = w[oc][k] (as f32) for k < k_len and oc < o, zero elsewhere
// in the [k_pad, o_pad] matrix: the wide route's B operand, padded so
// that its 16-byte copies need no mask.
template <typename TW>
__global__ void wide_prep_kernel(const TW* __restrict__ w,
                                 float* __restrict__ wt, int o, int k_len,
                                 int o_pad, long long total) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int k = (int)(i / o_pad);
    const int oc = (int)(i - (long long)k * o_pad);
    wt[i] = (k < k_len && oc < o) ? dl4j::to_f32(w[(size_t)oc * k_len + k])
                                  : 0.0f;
  }
}

// One TO x TP output tile. Thread (ty, tx) = (tid / 32, tid % 32) owns
// channels o0 + 32*mi + 4*ty + {0..3} (mi < MI) and pixels px0 + 32*j +
// tx (j < 4*PJ), or with kVecB px0 + 128*pj + 4*tx + {0..3} (pj < PJ).
// taps: [k_pad] int2 {ci*h*w + dh*w + dw, dh << 16 | dw}. The image is
// TX (f32, bf16 or f16) and the output TO (f32 or TX); the ring holds
// f32 either way: an f32 image is staged by 4-byte cp.async, a half one
// is loaded, converted and stored (synchronously: the slot it writes
// was freed by the barrier before the stage, and the barrier before its
// slice is summed publishes it).
template <typename TX, typename TO, int MI, int PJ, int kMinBlocks,
          bool kVecB>
__global__ void __launch_bounds__(wide::kThreads, kMinBlocks)
    conv_wide_kernel(const TX* __restrict__ x,
                     const float* __restrict__ wt,
                     const int2* __restrict__ taps,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift, TO* __restrict__ out,
                     int n, int c, int h, int wd, int o, int o_pad, int sh,
                     int sw, int ph, int pw, int oh, int ow, int k_pad,
                     int act) {
  using Tile = WideTile<MI, PJ>;
  constexpr int kTO = Tile::kTO;
  constexpr int kTP = Tile::kTP;
  constexpr int kMR = 4 * MI;  // channels a thread owns
  constexpr int kPR = 4 * PJ;  // pixels a thread owns
  extern __shared__ __align__(16) float smem[];
  int2* tab = reinterpret_cast<int2*>(smem + wide::kStages *
                                                 Tile::kStageFloats);
  const int tid = threadIdx.x;
  const int tx = tid & 31;
  const int ty = tid >> 5;
  const long long px0 = (long long)blockIdx.x * kTP;
  const int o0 = blockIdx.y * kTO;
  const int ohw = oh * ow;
  const long long n_px = (long long)n * ohw;
  const int num_k = k_pad / wide::kK;

  // the tap table first: the gather's addresses need it
  for (int i = tid; i < k_pad / 2; i += wide::kThreads)
    dl4j::cp_async16(tab + 2 * i, taps + 2 * i, 16);
  dl4j::cp_async_commit();

  // the im2col stager: one pixel a thread for the whole loop, k rows
  // akk0, akk0 + kARows, ... of each slice
  constexpr int kARows = wide::kThreads / kTP;  // 1 (TP 256) or 2
  constexpr int kAPer = wide::kK / kARows;
  const int ap = tid % kTP;
  const int akk0 = tid / kTP;
  int iy0 = -(1 << 30), ix0 = 0;  // a pixel past the batch: always masked
  long long xoff = 0;
  {
    const long long p = px0 + ap;
    if (p < n_px) {
      const int img = (int)(p / ohw);
      const int r = (int)(p - (long long)img * ohw);
      const int oy = r / ow;
      const int ox = r - oy * ow;
      iy0 = oy * sh - ph;
      ix0 = ox * sw - pw;
      xoff = (long long)img * c * h * wd + (long long)iy0 * wd + ix0;
    }
  }
  constexpr int kBCopies = wide::kK * kTO / 4;  // 16-byte copies of w_s
  auto stage = [&](int slot, int k0) {
    float* ws = smem + slot * Tile::kStageFloats;
    float* xs = ws + Tile::kWFloats;
#pragma unroll
    for (int i = 0; i < (kBCopies + wide::kThreads - 1) / wide::kThreads;
         ++i) {
      const int idx = tid + i * wide::kThreads;
      if (idx < kBCopies) {
        const int kk = idx / (kTO / 4);
        const int c4 = (idx - kk * (kTO / 4)) * 4;
        dl4j::cp_async16(ws + kk * kTO + c4,
                         wt + (size_t)(k0 + kk) * o_pad + o0 + c4, 16);
      }
    }
#pragma unroll
    for (int i = 0; i < kAPer; ++i) {
      const int kk = akk0 + i * kARows;
      const int2 e = tab[k0 + kk];
      const int iy = iy0 + (e.y >> 16);
      const int ix = ix0 + (e.y & 0xffff);
      const bool ok = (unsigned)iy < (unsigned)h && (unsigned)ix < (unsigned)wd;
      if constexpr (std::is_same_v<TX, float>) {
        const float* src = ok ? x + (xoff + e.x) : x;
        dl4j::cp_async4(xs + kk * kTP + ap, src, ok ? 4 : 0);
      } else {
        xs[kk * kTP + ap] = ok ? dl4j::to_f32(x[xoff + e.x]) : 0.0f;
      }
    }
  };

  float acc[kMR][kPR];
#pragma unroll
  for (int i = 0; i < kMR; ++i)
#pragma unroll
    for (int j = 0; j < kPR; ++j) acc[i][j] = 0.0f;

  dl4j::cp_async_wait<0>();
  __syncthreads();  // the table is in

  // fill all but one slot of the ring; one commit group per slice
  // (empty past the end) keeps the wait count uniform
#pragma unroll
  for (int s = 0; s < wide::kStages - 1; ++s) {
    if (s < num_k) stage(s, s * wide::kK);
    dl4j::cp_async_commit();
  }

  for (int kt = 0; kt < num_k; ++kt) {
    dl4j::cp_async_wait<wide::kStages - 2>();  // slice kt has landed
    __syncthreads();  // ... for every thread, and slot kt-1 is free
    const int next = kt + wide::kStages - 1;
    if (next < num_k) stage(next % wide::kStages, next * wide::kK);
    dl4j::cp_async_commit();

    const float* ws = smem + (kt % wide::kStages) * Tile::kStageFloats;
    const float* xs = ws + Tile::kWFloats;
#pragma unroll
    for (int kk = 0; kk < wide::kK; ++kk) {
      float a[kMR], b[kPR];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float4 v = *reinterpret_cast<const float4*>(
            ws + kk * kTO + 32 * mi + 4 * ty);
        a[4 * mi] = v.x;
        a[4 * mi + 1] = v.y;
        a[4 * mi + 2] = v.z;
        a[4 * mi + 3] = v.w;
      }
#pragma unroll
      if constexpr (kVecB) {
#pragma unroll
        for (int pj = 0; pj < PJ; ++pj) {
          const float4 v = *reinterpret_cast<const float4*>(
              xs + kk * kTP + 128 * pj + 4 * tx);
          b[4 * pj] = v.x;
          b[4 * pj + 1] = v.y;
          b[4 * pj + 2] = v.z;
          b[4 * pj + 3] = v.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPR; ++j) b[j] = xs[kk * kTP + 32 * j + tx];
      }
#pragma unroll
      for (int i = 0; i < kMR; ++i)
#pragma unroll
        for (int j = 0; j < kPR; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  dl4j::cp_async_wait<0>();  // no copy outlives the block

  float sc[kMR], sf[kMR];
#pragma unroll
  for (int i = 0; i < kMR; ++i) {
    const int oc = o0 + 32 * (i / 4) + 4 * ty + (i % 4);
    sc[i] = oc < o ? scale[oc] : 0.0f;
    sf[i] = oc < o ? shift[oc] : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < kPR; ++j) {
    const long long p = kVecB ? px0 + 128 * (j / 4) + 4 * tx + (j % 4)
                              : px0 + 32 * j + tx;
    if (p >= n_px) continue;
    const int img = (int)(p / ohw);
    const int r = (int)(p - (long long)img * ohw);
    TO* dst = out + (size_t)img * o * ohw + r;
#pragma unroll
    for (int i = 0; i < kMR; ++i) {
      const int oc = o0 + 32 * (i / 4) + 4 * ty + (i % 4);
      if (oc < o)
        dst[(size_t)oc * ohw] = dl4j::from_f32<TO>(
            dl4j::apply_act(acc[i][j] * sc[i] + sf[i], act));
    }
  }
}

template <typename TX, typename TO, int MI, int PJ, int kMinBlocks,
          bool kVecB>
int launch_wide_as(const TX* x, const TX* w, float* wt,
                   const int2* taps, const float* scale, const float* shift,
                   TO* out, int n, int c, int h, int wd, int o, int kh,
                   int kw, int sh, int sw, int ph, int pw, int oh, int ow,
                   int k_pad, int act, cudaStream_t stream) {
  using Tile = WideTile<MI, PJ>;
  static unsigned smem_set = 0;  // devices whose cap is raised
  auto kernel = conv_wide_kernel<TX, TO, MI, PJ, kMinBlocks, kVecB>;
  // the cap is raised once, to all a block may take; a launch asks for
  // its own ring and table
  const int smem = wide_smem_bytes<MI, PJ>(k_pad);
  if (smem > dl4j::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  int rc = dl4j::allow_dynamic_smem(kernel, dl4j::kMaxSmemBytes, &smem_set);
  if (rc != 0) return rc;
  const int k_len = c * kh * kw;
  const int o_pad = dl4j::ceil_div(o, Tile::kTO) * Tile::kTO;
  const long long total = (long long)k_pad * o_pad;
  long long blocks = (total + 255) / 256;
  if (blocks > 4 * dl4j::kSmCount * 8) blocks = 4 * dl4j::kSmCount * 8;
  wide_prep_kernel<TX><<<(unsigned)blocks, 256, 0, stream>>>(
      w, wt, o, k_len, o_pad, total);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const long long n_px = (long long)n * oh * ow;
  const long long px_blocks = (n_px + Tile::kTP - 1) / Tile::kTP;
  if (px_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)px_blocks, (unsigned)(o_pad / Tile::kTO));
  kernel<<<grid, wide::kThreads, smem, stream>>>(
      x, wt, taps, scale, shift, out, n, c, h, wd, o, o_pad, sh, sw, ph, pw,
      oh, ow, k_pad, act);
  return (int)cudaGetLastError();
}

// The wide tiles this build has, by (TO, TP): each names its blocks an
// SM for __launch_bounds__ and whether a thread's pixels are float4
// groups (kVecB; ops/conv_block.py WIDE_TILES).
#define DL4J_WIDE_TILES(X)  \
  X(96, 256, 3, 2, 1, true) \
  X(128, 128, 4, 1, 2, true) \
  X(96, 128, 3, 1, 2, false) \
  X(32, 256, 1, 2, 2, false)

template <typename TX, typename TO>
int launch_wide(const void* x, const void* w, void* wt, const void* taps,
                const float* scale, const float* shift, void* out, int n,
                int c, int h, int wd, int o, int kh, int kw, int sh, int sw,
                int ph, int pw, int oh, int ow, int act, int tile_o,
                int tile_px, int k_pad, cudaStream_t stream) {
  if (wt == nullptr || taps == nullptr || k_pad <= 0 || k_pad % wide::kK ||
      k_pad < c * kh * kw || h + ph >= wide::kPadTap || kw > 0xffff ||
      (long long)c * h * wd >= (1LL << 31))  // the table's int32 offsets
    return (int)cudaErrorInvalidValue;
#define DL4J_WIDE_CASE(TILE_O, TILE_P, MI, PJ, MINB, VEC)                  \
  if (tile_o == TILE_O && tile_px == TILE_P)                               \
    return launch_wide_as<TX, TO, MI, PJ, MINB, VEC>(                      \
        static_cast<const TX*>(x), static_cast<const TX*>(w),              \
        static_cast<float*>(wt), static_cast<const int2*>(taps), scale,    \
        shift, static_cast<TO*>(out), n, c, h, wd, o, kh, kw, sh, sw,      \
        ph, pw, oh, ow, k_pad, act, stream);
  DL4J_WIDE_TILES(DL4J_WIDE_CASE)
#undef DL4J_WIDE_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// The number of k chunks for this conv (1: no split); the wrapper
// allocates an f32 scratch of splits * n * o * oh * ow when it is > 1.
extern "C" int dl4j_conv_block_splits(int n, int c, int o, int kh, int kw,
                                      int oh, int ow) {
  if (n <= 0 || o <= 0 || oh <= 0 || ow <= 0) return 1;
  return dl4j::plan_splits(tiles(n, o, oh, ow), c * kh * kw);
}

// Dynamic shared memory of a wide block of tile (tile_o, tile_px) at a
// padded depth k_pad, or -1 when this build has no such tile.
extern "C" int dl4j_conv_wide_smem_bytes(int tile_o, int tile_px,
                                         int k_pad) {
#define DL4J_WIDE_CASE(TO, TP, MI, PJ, MINB, VEC) \
  if (tile_o == TO && tile_px == TP) return wide_smem_bytes<MI, PJ>(k_pad);
  DL4J_WIDE_TILES(DL4J_WIDE_CASE)
#undef DL4J_WIDE_CASE
  return -1;
}

// Returns the cudaError_t of the launch (0 on success). Shapes are
// validated by the Python wrapper (ops/conv_block.py), which also picks
// `route` (enum Route) from the shape. x and w are `dtype` (enum DType),
// out is `out_dtype`: `dtype` or f32 (the backward's f32 recompute of a
// half conv). Direct route: `partial` is the split-K scratch (null when
// splits is 1); wt, taps, tile_o, tile_px and k_pad are unused. Wide
// route (splits 1): `wt` is an f32 scratch of k_pad * o_pad (o rounded
// up to tile_o) for the transposed weights, `taps` the [k_pad] int2 tap
// table (ops/conv_block.py conv_tap_table), k_pad the depth rounded up
// to 16.
extern "C" int dl4j_conv_block(const void* x, const void* w, void* wt,
                               const void* taps, const void* scale,
                               const void* shift, void* out, void* partial,
                               int dtype, int out_dtype, int n, int c, int h,
                               int wd, int o,
                               int kh, int kw, int sh, int sw, int ph, int pw,
                               int oh, int ow, int act, int splits, int route,
                               int tile_o, int tile_px, int k_pad,
                               void* stream) {
  if (n <= 0 || o <= 0 || oh <= 0 || ow <= 0) return 0;
  const float* sc = static_cast<const float*>(scale);
  const float* sf = static_cast<const float*>(shift);
  float* ws = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route != kRouteWide && route != kRouteDirect)
    return (int)cudaErrorInvalidValue;
  if (route == kRouteWide && splits != 1) return (int)cudaErrorInvalidValue;
  if (out_dtype != dtype && out_dtype != dl4j::kF32)
    return (int)cudaErrorInvalidValue;
  const bool f32_out = out_dtype == dl4j::kF32;
#define DL4J_CONV_ROUTE(T, TO)                                                \
  return route == kRouteWide                                                 \
             ? launch_wide<T, TO>(x, w, wt, taps, sc, sf, out, n, c, h, wd, o, \
                                  kh, kw, sh, sw, ph, pw, oh, ow, act,       \
                                  tile_o, tile_px, k_pad, st)                \
             : launch<T, TO>(x, w, sc, sf, out, ws, n, c, h, wd, o, kh, kw,  \
                             sh, sw, ph, pw, oh, ow, act, splits, st);
  switch (dtype) {
    case dl4j::kF32:
      DL4J_CONV_ROUTE(float, float)
    case dl4j::kBF16:
      if (f32_out) DL4J_CONV_ROUTE(__nv_bfloat16, float)
      DL4J_CONV_ROUTE(__nv_bfloat16, __nv_bfloat16)
    case dl4j::kF16:
      if (f32_out) DL4J_CONV_ROUTE(__half, float)
      DL4J_CONV_ROUTE(__half, __half)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DL4J_CONV_ROUTE
}
