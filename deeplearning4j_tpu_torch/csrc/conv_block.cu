// Fused direct convolution: out = act((conv2d(x, w)) * scale + shift).
//
// Replaces deeplearning4j_tpu/ops/conv_block.py::_conv_kernel (the
// forward, reached through _direct_conv_call from conv_block).
//
// Layout: x NCHW [n, c, h, w], w OIHW [o, c, kh, kw], scale/shift f32
// [o], out NCHW [n, o, oh, ow]. x, w and out share one element type
// (f32, bf16 or f16); products accumulate in f32 registers and are cast
// once on the store, as the TPU kernel does.
//
// What bounds it on an H100: at the slice's shapes the conv is
// arithmetic-heavy (AlexNet conv2 at batch 64: 57 GFLOP against 68 MB
// moved, about 840 FLOP per byte; LeNet conv2 at batch 32: 102 MFLOP
// against 0.9 MB). With FP32 FMA (no tensor cores: TF32 would not hold
// f32 parity) the floor is the 67 TFLOP/s FP32 rate, so operations,
// not bytes, bound it.
//
// Design: an implicit GEMM. The output is a matrix [o, n*oh*ow] and the
// reduction runs over k = (ci, dh, dw), c*kh*kw long. Each block owns a
// 64-channel x 64-pixel output tile (pixels flattened over the batch, so
// LeNet's 8x8 maps still fill blocks) and walks k in slices of 16: it
// stages the weight slice and the matching im2col slice of the input in
// shared memory (the im2col exists only there, one slice at a time), with
// padding done by bounds checks while staging. Each of the 256 threads
// keeps a 4x4 block of f32 accumulators in registers, 16 FMAs per 8
// shared-memory reads. The epilogue (folded bias / BN affine plus the
// activation) runs on the accumulators before the single store. AlexNet
// conv1 (c=3, 11x11, stride 4) is the same loop: its 363-long k axis is
// cut into slices the same way, so the tiny channel depth costs nothing
// special.
//
// A small conv has few tiles (LeNet's second conv at the serving bucket
// of 32: 32 tiles for 132 SMs). Then the k axis is split over
// blockIdx.z until about two waves of blocks are in flight
// (common.cuh plan_splits); each split writes its f32 sums to a scratch
// and splitk_finish adds them in a fixed order and applies the
// epilogue, so the result is deterministic.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kOcBlock = 64;   // output channels per block
constexpr int kPxBlock = 64;   // output pixels (over n*oh*ow) per block
constexpr int kKSlice = 16;    // reduction slice staged per iteration
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

template <typename T>
__global__ void __launch_bounds__(kThreads)
    conv_block_kernel(const T* __restrict__ x, const T* __restrict__ w,
                      const float* __restrict__ scale,
                      const float* __restrict__ shift, T* __restrict__ out,
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
        out[idx] = dl4j::from_f32<T>(z);
      }
    }
  }
}

long long tiles(int n, int o, int oh, int ow) {
  const long long n_px = (long long)n * oh * ow;
  return ((n_px + kPxBlock - 1) / kPxBlock) * dl4j::ceil_div(o, kOcBlock);
}

template <typename T>
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
  conv_block_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), scale, shift,
      static_cast<T*>(out), z > 1 ? partial : nullptr, n, c, h, wd, o, kh,
      kw, sh, sw, ph, pw, oh, ow, k_chunk, act);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || z == 1) return rc;
  return dl4j::launch_splitk_finish<T>(partial, z, n_px * o, scale, shift,
                                       (long long)oh * ow, o, act,
                                       static_cast<T*>(out), stream);
}

}  // namespace

// The number of k chunks for this conv (1: no split); the wrapper
// allocates an f32 scratch of splits * n * o * oh * ow when it is > 1.
extern "C" int dl4j_conv_block_splits(int n, int c, int o, int kh, int kw,
                                      int oh, int ow) {
  if (n <= 0 || o <= 0 || oh <= 0 || ow <= 0) return 1;
  return dl4j::plan_splits(tiles(n, o, oh, ow), c * kh * kw);
}

// Returns the cudaError_t of the launch (0 on success). Shapes are
// validated by the Python wrapper (ops/conv_block.py); `partial` is the
// split-K scratch (null when splits is 1).
extern "C" int dl4j_conv_block(const void* x, const void* w,
                               const void* scale, const void* shift,
                               void* out, void* partial, int dtype, int n,
                               int c, int h, int wd, int o, int kh, int kw,
                               int sh, int sw, int ph, int pw, int oh, int ow,
                               int act, int splits, void* stream) {
  if (n <= 0 || o <= 0 || oh <= 0 || ow <= 0) return 0;
  const float* sc = static_cast<const float*>(scale);
  const float* sf = static_cast<const float*>(shift);
  float* ws = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case dl4j::kF32:
      return launch<float>(x, w, sc, sf, out, ws, n, c, h, wd, o, kh, kw, sh,
                           sw, ph, pw, oh, ow, act, splits, st);
    case dl4j::kBF16:
      return launch<__nv_bfloat16>(x, w, sc, sf, out, ws, n, c, h, wd, o, kh,
                                   kw, sh, sw, ph, pw, oh, ow, act, splits,
                                   st);
    case dl4j::kF16:
      return launch<__half>(x, w, sc, sf, out, ws, n, c, h, wd, o, kh, kw, sh,
                            sw, ph, pw, oh, ow, act, splits, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
