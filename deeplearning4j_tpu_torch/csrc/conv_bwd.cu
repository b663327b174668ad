// The two gradients of a convolution, for the conv_block backward:
//
//   conv_bwd_data: dL/dx [n, c, h, w] from the f32 pre-epilogue gradient
//     dacc [n, o, oh, ow] and the weights w [o, c, kh, kw];
//   conv_bwd_w:    dL/dW [o, c, kh, kw] from the input x [n, c, h, w]
//     and dacc.
//
// Replace deeplearning4j_tpu/ops/conv_block.py::_conv_kernel as launched
// for the backward-data pass (_conv_block_bwd: the forward kernel on the
// interior-dilated, edge-padded gradient and the flipped weights) and
// ::_conv_bwd_w_kernel (batch as the innermost revisited grid axis, an
// f32 [kh, kw, c, oc_b] block accumulated across it).
//
// Everything is f32 (inputs, accumulators, outputs): the backward of the
// port trains in f32. Layouts are NCHW / OIHW as at the public API, so
// no transposed, padded or dilated copy of any operand is made: padding,
// stride and the transposition are index arithmetic while staging.
//
// What bounds them on an H100: at LeNet's training shapes (batch 256)
// both are small (conv2 dx: 0.82 GFLOP useful; conv1 dW: 0.15 GFLOP over
// 12 MB); at AlexNet's they are FP32-FMA bound like the forward
// (conv2 dW at batch 64: 57 GFLOP). No tensor cores: TF32 would not hold
// f32 parity. So operations bound them, except conv1 dW (bytes).
//
// Design: both are implicit GEMMs on the forward kernel's tile shape
// (64 x 64 output tile, 16-deep reduction slices staged in shared
// memory, 256 threads with 4 x 4 f32 accumulators each).
//
// - Backward-data is a gather: the output is [c, n*h*w] (input channels
//   by input pixels, flattened over the batch) and the reduction runs
//   over k = (o, dh, dw). For input pixel (iy, ix) and tap (dh, dw) the
//   gradient element is dacc[oy, ox] with oy*sh = iy + ph - dh (and the
//   same for x); a tap with no such (oy, ox) (outside the map, or between
//   strides) stages a zero and reads nothing. Unlike the TPU route there
//   is no dilated, padded copy of the gradient in memory; the zero taps
//   are still multiplied in shared memory (at LeNet conv2, 8x8 gradient
//   maps under 12x12 inputs, 2.25x the useful FMAs).
// - Backward-weights is [o, c*kh*kw] over a reduction r = (n, oy, ox).
//   The output is tiny and the reduction deep, so the reduction is split
//   over blockIdx.z by its own plan (common.cuh plan_dw_splits: about
//   two waves of blocks on 132 SMs). Each split writes f32 partial sums
//   to a scratch the wrapper allocates and splitk_finish adds them in a
//   fixed order: no atomics, so two runs give the same bits.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int kRowBlock = 64;  // output rows per block
constexpr int kColBlock = 64;  // output columns per block
constexpr int kKSlice = 16;    // reduction slice staged per iteration
constexpr int kThreads = 256;  // 16 x 16 threads, 4 x 4 outputs each

// dx[img, ci, iy, ix] = sum over (oc, dh, dw) of
//   w[oc, ci, dh, dw] * dacc[img, oc, (iy + ph - dh) / sh, (ix + pw - dw) / sw]
// where both quotients are exact and inside the gradient map.
__global__ void __launch_bounds__(kThreads)
    conv_bwd_data_kernel(const float* __restrict__ dacc,
                         const float* __restrict__ w, float* __restrict__ dx,
                         float* __restrict__ partial, int n, int c, int h,
                         int wd, int o, int kh, int kw, int sh, int sw, int ph,
                         int pw, int oh, int ow, int k_chunk) {
  __shared__ float w_s[kKSlice][kRowBlock + 4];
  __shared__ float g_s[kKSlice][kColBlock];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // pixel group of this thread's outputs
  const int ty = tid / 16;  // channel group of this thread's outputs
  const int px0 = blockIdx.x * kColBlock;
  const int c0 = blockIdx.y * kRowBlock;
  const int khw = kh * kw;
  const int k_len = o * khw;
  const int hw = h * wd;
  const int ohw = oh * ow;
  const int n_px = n * hw;
  const int k_lo = blockIdx.z * k_chunk;
  const int k_hi = min(k_len, k_lo + k_chunk);

  // gradient stager: one input pixel per thread, k rows lk, lk+4, ...
  const int lp = tid % kColBlock;
  const int lk = tid / kColBlock;
  const int gp = px0 + lp;
  const bool px_ok = gp < n_px;
  int yy0 = 0, xx0 = 0;  // the pixel's position in the padded input
  const float* g_img = dacc;
  if (px_ok) {
    const int img = gp / hw;
    const int r = gp - img * hw;
    const int iy = r / wd;
    yy0 = iy + ph;
    xx0 = r - iy * wd + pw;
    g_img = dacc + (size_t)img * o * ohw;
  }
  // weight stager: one k column per thread, channel rows wc, wc+16, ...
  const int wk = tid % kKSlice;
  const int wc = tid / kKSlice;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_lo; k0 < k_hi; k0 += kKSlice) {
    {
      const int k = k0 + wk;
      const bool k_ok = k < k_hi;
      const int oc = k_ok ? k / khw : 0;
      const int tap = k - oc * khw;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int ci = c0 + wc + 16 * i;
        float v = 0.0f;
        if (k_ok && ci < c) v = w[((size_t)oc * c + ci) * khw + tap];
        w_s[wk][wc + 16 * i] = v;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kk = lk + 4 * i;
      const int k = k0 + kk;
      float v = 0.0f;
      if (px_ok && k < k_hi) {
        const int oc = k / khw;
        const int tap = k - oc * khw;
        const int dh = tap / kw;
        const int yy = yy0 - dh;
        const int xx = xx0 - (tap - dh * kw);
        if (yy >= 0 && xx >= 0) {
          const int oy = yy / sh;
          const int ox = xx / sw;
          if (oy * sh == yy && ox * sw == xx && oy < oh && ox < ow)
            v = g_img[(size_t)oc * ohw + oy * ow + ox];
        }
      }
      g_s[kk][lp] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKSlice; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = w_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = g_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ci = c0 + ty + 16 * i;
    if (ci >= c) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p = px0 + tx + 16 * j;
      if (p >= n_px) continue;
      const int img = p / hw;
      const size_t idx = ((size_t)img * c + ci) * hw + (p - img * hw);
      if (partial != nullptr)
        partial[(size_t)blockIdx.z * n_px * c + idx] = acc[i][j];
      else
        dx[idx] = acc[i][j];
    }
  }
}

// dW[oc, k2] = sum over r = (img, oy, ox) of dacc[img, oc, oy, ox] *
//   x[img, ci, oy*sh - ph + dh, ox*sw - pw + dw], k2 = (ci, dh, dw),
// zero where the window leaves the image. This block sums r in
// [r_lo, r_lo + r_chunk).
__global__ void __launch_bounds__(kThreads)
    conv_bwd_w_kernel(const float* __restrict__ x,
                      const float* __restrict__ dacc, float* __restrict__ dw,
                      float* __restrict__ partial, int n, int c, int h,
                      int wd, int o, int kh, int kw, int sh, int sw, int ph,
                      int pw, int oh, int ow, long long r_chunk) {
  __shared__ float g_s[kKSlice][kRowBlock + 4];
  __shared__ float x_s[kKSlice][kColBlock + 4];

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // k2 group of this thread's outputs
  const int ty = tid / 16;  // channel group of this thread's outputs
  const int k20 = blockIdx.x * kColBlock;
  const int o0 = blockIdx.y * kRowBlock;
  const int khw = kh * kw;
  const int k2_len = c * khw;
  const int ohw = oh * ow;
  const long long r_len = (long long)n * ohw;
  const long long r_lo = (long long)blockIdx.z * r_chunk;
  const long long r_hi = r_lo + r_chunk < r_len ? r_lo + r_chunk : r_len;

  // stagers: one r row per thread (lr), columns lc, lc+16, lc+32, lc+48
  // of both operands; the columns' (ci, dh, dw) are loop invariants
  const int lr = tid % kKSlice;
  const int lc = tid / kKSlice;
  int col_ci[4], col_dh[4], col_dw[4];
  bool col_ok[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k2 = k20 + lc + 16 * i;
    col_ok[i] = k2 < k2_len;
    const int ci = col_ok[i] ? k2 / khw : 0;
    const int tap = col_ok[i] ? k2 - ci * khw : 0;
    col_ci[i] = ci;
    col_dh[i] = tap / kw;
    col_dw[i] = tap - (tap / kw) * kw;
  }

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (long long r0 = r_lo; r0 < r_hi; r0 += kKSlice) {
    const long long r = r0 + lr;
    const bool r_ok = r < r_hi;
    int img = 0, q = 0, iy0 = 0, ix0 = 0;
    if (r_ok) {
      img = (int)(r / ohw);
      q = (int)(r - (long long)img * ohw);
      const int oy = q / ow;
      iy0 = oy * sh - ph;
      ix0 = (q - oy * ow) * sw - pw;
    }
    const float* g_img = dacc + (size_t)img * o * ohw + q;
    const float* x_img = x + (size_t)img * c * h * wd;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int oc = o0 + lc + 16 * i;
      float v = 0.0f;
      if (r_ok && oc < o) v = g_img[(size_t)oc * ohw];
      g_s[lr][lc + 16 * i] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = 0.0f;
      if (r_ok && col_ok[i]) {
        const int iy = iy0 + col_dh[i];
        const int ix = ix0 + col_dw[i];
        if (iy >= 0 && iy < h && ix >= 0 && ix < wd)
          v = x_img[((size_t)col_ci[i] * h + iy) * wd + ix];
      }
      x_s[lr][lc + 16 * i] = v;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kKSlice; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = g_s[kk][ty + 16 * i];
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
    const int oc = o0 + ty + 16 * i;
    if (oc >= o) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k2 = k20 + tx + 16 * j;
      if (k2 >= k2_len) continue;
      const size_t idx = (size_t)oc * k2_len + k2;
      if (partial != nullptr)
        partial[(size_t)blockIdx.z * o * k2_len + idx] = acc[i][j];
      else
        dw[idx] = acc[i][j];
    }
  }
}

long long data_tiles(int n, int c, int h, int wd) {
  const long long n_px = (long long)n * h * wd;
  return ((n_px + kColBlock - 1) / kColBlock) * dl4j::ceil_div(c, kRowBlock);
}

long long weight_tiles(int c, int o, int kh, int kw) {
  const long long k2_len = (long long)c * kh * kw;
  return ((k2_len + kColBlock - 1) / kColBlock) *
         dl4j::ceil_div(o, kRowBlock);
}

bool bad_geometry(int n, int c, int h, int wd, int o, int kh, int kw, int sh,
                  int sw, int ph, int pw, int oh, int ow) {
  return n <= 0 || c <= 0 || h <= 0 || wd <= 0 || o <= 0 || kh <= 0 ||
         kw <= 0 || sh <= 0 || sw <= 0 || ph < 0 || pw < 0 || oh <= 0 ||
         ow <= 0;
}

}  // namespace

// The number of k chunks for dL/dx (1: no split); the wrapper allocates
// an f32 scratch of splits * n * c * h * w when it is > 1.
extern "C" int dl4j_conv_bwd_data_splits(int n, int c, int h, int wd, int o,
                                         int kh, int kw) {
  if (n <= 0 || c <= 0 || h <= 0 || wd <= 0) return 1;
  return dl4j::plan_splits(data_tiles(n, c, h, wd), o * kh * kw);
}

// dL/dx (f32). Returns the cudaError_t of the launches (0 on success).
// Shapes are validated by the Python wrapper (ops/conv_block.py);
// `partial` is the split scratch (null when splits is 1).
extern "C" int dl4j_conv_bwd_data(const void* dacc, const void* w, void* dx,
                                  void* partial, int n, int c, int h, int wd,
                                  int o, int kh, int kw, int sh, int sw,
                                  int ph, int pw, int oh, int ow, int splits,
                                  void* stream) {
  if (bad_geometry(n, c, h, wd, o, kh, kw, sh, sw, ph, pw, oh, ow))
    return (int)cudaErrorInvalidValue;
  const long long n_px = (long long)n * h * wd;
  const long long px_blocks = (n_px + kColBlock - 1) / kColBlock;
  const int c_blocks = dl4j::ceil_div(c, kRowBlock);
  if (px_blocks > 0x7fffffffLL || c_blocks > 65535 ||
      n_px * c > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int k_len = o * kh * kw;
  int k_chunk = k_len;
  int z = 1;
  if (splits > 1) {
    if (partial == nullptr) return (int)cudaErrorInvalidValue;
    k_chunk = dl4j::k_chunk_for(k_len, splits);
    z = dl4j::ceil_div(k_len, k_chunk);
    if (z > splits) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  float* out = static_cast<float*>(dx);
  dim3 grid((unsigned)px_blocks, (unsigned)c_blocks, (unsigned)z);
  conv_bwd_data_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(dacc), static_cast<const float*>(w), out,
      z > 1 ? ws : nullptr, n, c, h, wd, o, kh, kw, sh, sw, ph, pw, oh, ow,
      k_chunk);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || z == 1) return rc;
  return dl4j::launch_splitk_finish<float>(ws, z, n_px * c, nullptr, nullptr,
                                           1, 1, dl4j::kIdentity, out, st);
}

// The number of reduction chunks for dL/dW (1: no split); the wrapper
// allocates an f32 scratch of splits * o * c * kh * kw when it is > 1.
extern "C" int dl4j_conv_bwd_w_splits(int n, int c, int o, int kh, int kw,
                                      int oh, int ow) {
  if (n <= 0 || c <= 0 || o <= 0 || oh <= 0 || ow <= 0) return 1;
  return dl4j::plan_dw_splits(weight_tiles(c, o, kh, kw),
                              (long long)n * oh * ow);
}

// dL/dW (f32, OIHW). Returns the cudaError_t of the launches.
extern "C" int dl4j_conv_bwd_w(const void* x, const void* dacc, void* dw,
                               void* partial, int n, int c, int h, int wd,
                               int o, int kh, int kw, int sh, int sw, int ph,
                               int pw, int oh, int ow, int splits,
                               void* stream) {
  if (bad_geometry(n, c, h, wd, o, kh, kw, sh, sw, ph, pw, oh, ow))
    return (int)cudaErrorInvalidValue;
  const long long k2_len = (long long)c * kh * kw;
  const long long k2_blocks = (k2_len + kColBlock - 1) / kColBlock;
  const int o_blocks = dl4j::ceil_div(o, kRowBlock);
  if (k2_blocks > 0x7fffffffLL || o_blocks > 65535 ||
      (long long)n * c * h * wd > 0x7fffffffLL ||
      (long long)n * o * oh * ow > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long r_len = (long long)n * oh * ow;
  long long r_chunk = r_len;
  int z = 1;
  if (splits > 1) {
    if (partial == nullptr || splits > 65535) return (int)cudaErrorInvalidValue;
    r_chunk = dl4j::r_chunk_for(r_len, splits);
    z = (int)((r_len + r_chunk - 1) / r_chunk);
    if (z > splits) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  float* out = static_cast<float*>(dw);
  dim3 grid((unsigned)k2_blocks, (unsigned)o_blocks, (unsigned)z);
  conv_bwd_w_kernel<<<grid, kThreads, 0, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(dacc), out,
      z > 1 ? ws : nullptr, n, c, h, wd, o, kh, kw, sh, sw, ph, pw, oh, ow,
      r_chunk);
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || z == 1) return rc;
  return dl4j::launch_splitk_finish<float>(ws, z, (long long)o * k2_len,
                                           nullptr, nullptr, 1, 1,
                                           dl4j::kIdentity, out, st);
}
