// The two gradients of a convolution, for the conv_block backward:
//
//   conv_bwd_data: dL/dx [n, c, h, w] from the f32 pre-epilogue gradient
//     dacc [n, o, oh, ow] and the weights w [o, c, kh, kw];
//   conv_bwd_w:    dL/dW [o, c, kh, kw] from the input x [n, c, h, w]
//     and dacc.
//
// Replace deeplearning4j_tpu/ops/conv_block.py::_conv_kernel as launched
// for the backward-data pass (_conv_block_bwd, :465: the forward kernel
// on the interior-dilated, edge-padded gradient and the flipped
// weights) and ::_conv_bwd_w_kernel (batch as the innermost revisited
// grid axis, an f32 [kh, kw, c, oc_b] block accumulated across it).
//
// Accumulators, dacc, the weights, dx and dW are f32, as in the JAX
// backward; the image x of conv_bwd_w is in the forward's dtype (f32,
// bf16 or f16), converted to f32 as it is staged. Layouts are NCHW / OIHW as at the public API, and
// no padded or dilated copy of any operand is made in device memory:
// padding and stride are index arithmetic (the one copy is the resident
// route's transposed weights, kh*kw*o*c f32). No tensor cores: TF32 would not hold f32 parity. Nothing
// uses atomics, so two launches give the same bits.
//
// conv_bwd_data has two routes, picked by the wrapper from the shape
// alone (ops/conv_block.py conv_bwd_data_route):
//
// - resident, for convolutions whose gradient map, weights and dx fit in
//   shared memory: LeNet conv2 at batch 256 (dacc [256, 50, 8, 8], w
//   [50, 20, 5, 5]: 0.82 GFLOP of useful multiply-adds, an FP32 bound of
//   12 us). The implicit GEMM below spent 0.58 ms there: c = 20 channels
//   on its 64-row tile left 44 rows computing zeros (3.2x), it
//   multiplied the taps that fall outside the 8 x 8 gradient map
//   (2.25x), it paid integer divisions for every staged element, and
//   nothing overlapped its staging. Here the gather turns into a scatter
//   by tap: for a tap (dh, dw) every gradient pixel (oy, ox) feeds
//   exactly one input pixel, (oy*sh - ph + dh, ox*sw - pw + dw), so a
//   tap is a small product [c x o] by [o x oh*ow] added into a shifted
//   window of dx, and no product falls outside the map (only those that
//   land on the padding are skipped). One block owns one image and a
//   group of at most 32 input channels (more groups where the weights
//   would not fit). It stages the image's gradient (o*oh*ow f32, 12.8
//   KB at LeNet conv2) and the group's weights (100 KB), both in 16-byte
//   cp.async copies into dynamic shared memory: a one-pass kernel first
//   writes the weights transposed to [group][tap][oc][channel], so no
//   block divides an index to stage them (two divisions an element,
//   in every block, cost more than the transpose). A thread owns one
//   (channel quad, gradient pixel) item of a tap: the loop over o is
//   innermost, one
//   shared load of the gradient (a warp's lanes on consecutive pixels)
//   and one broadcast float4 of weights per 4 FMAs, and the 4 sums are
//   added to the dx tile in shared memory, which a barrier between taps
//   keeps race-free. The block's threads form up to kh*kw tap groups,
//   each with a dx tile of its own over a run of the taps, added in
//   order at the end: LeNet conv2 runs 3 groups of 320 threads (147 KB
//   of shared memory, one block an SM). Shared-load latency bounds it:
//   the time fell with the threads an SM holds (0.092 ms at 320, 0.068
//   at 640 and 960 on an NVIDIA H100 80GB HBM3, scripts/torch_route_ab.py
//   --groups).
// - gemm, for the rest (AlexNet's conv2-conv5, whose maps do not fit):
//   an implicit GEMM on the forward kernel's tile shape (64 x 64 output
//   tile, 16-deep reduction slices staged in shared memory, 256 threads
//   with 4 x 4 f32 accumulators), the output [c, n*h*w] over a reduction
//   k = (o, dh, dw). For input pixel (iy, ix) and tap (dh, dw) the
//   gradient element is dacc[oy, ox] with oy*sh = iy + ph - dh (and the
//   same for x); a tap with no such (oy, ox) stages a zero and reads
//   nothing. FP32 FMA bounds it at AlexNet's shapes. With few tiles the
//   reduction splits (common.cuh plan_splits) into a scratch that
//   splitk_finish adds in a fixed order.
//
// conv_bwd_w replaces ::_conv_bwd_w_kernel (:184), which keeps an f32
// [kh, kw, c, oc_b] block of dW resident while whole images stream past
// and runs one per-tap contraction an image, over a grid whose batch
// axis is revisited in order. dW is tiny and its reduction deep: at
// LeNet's step, conv1 dW [20, 1, 5, 5] sums 147,456 products an entry
// (0.147 GFLOP over 12.6 MB, 11.8 of it the gradient map: bytes bound
// it, 3.76 us at 3.35 TB/s) and conv2 dW [50, 20, 5, 5] 16,384 (0.819
// GFLOP, operations: 12.2 us at 67 TFLOP/s). It has two routes, picked
// by the wrapper from the shape alone (ops/conv_block.py
// conv_bwd_w_route):
//
// - image_resident, for square kernels up to 5 x 5 whose two staged
//   images fit in shared memory: LeNet's conv1 and conv2. The TPU
//   kernel's idea carries over (whole images pass a resident sum), its
//   schedule does not: blocks run in parallel and in no order, so a
//   block owns a chunk of images and a group of input channels, stages
//   each image's x slab and gradient map with cp.async (two buffers, the
//   next image in flight) and sums into registers; a fixed-order finish
//   (dw_finish_kernel) adds the chunks' partial dW. The first version,
//   the implicit GEMM below, ran 0.152 ms over LeNet's step on an H100:
//   its 64 x 64 tile was 12 % full at conv1 (20 x 25) and 76 % at conv2,
//   it gathered each x element from device memory once per tap, split
//   conv1 264 ways through a one-load-at-a-time finish, and issued 8
//   shared loads per 16 FMAs. Here a thread's item is one (output quad,
//   tap row, channel): 4 x kw sums, fed along each gradient row by a
//   kw-wide window that slides over the input row (one new load a
//   pixel) and 4 gradient broadcasts, so no FMA falls outside dW and x
//   is read from device memory once. Odd and padded shared strides keep
//   a warp's loads free of bank conflicts; the block's dW slice leaves
//   through shared memory as whole runs. Two blocks an SM. At conv2 it
//   runs at 16 TFLOP/s (0.052 ms on an H100): a pixel's 20 FMAs share
//   the issue slots with the window moves, the five loads, addressing
//   and the loop.
// - gemm, for the rest (AlexNet's dW: one conv1 image is 602 KB, its
//   gradient maps 173-746 KB): [o, c*kh*kw] over a reduction r = (n, oy,
//   ox) on the implicit GEMM's 64 x 64 tile, split over blockIdx.z by
//   its own plan (common.cuh plan_dw_splits: about two waves of blocks
//   on 132 SMs); each split writes f32 partial sums to a scratch the
//   wrapper allocates and splitk_finish adds them in a fixed order.
#include <stdint.h>

#include <type_traits>

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
// [r_lo, r_lo + r_chunk). x is TX (f32, bf16 or f16), converted to f32
// as it is staged; dacc and dW are f32.
template <typename TX>
__global__ void __launch_bounds__(kThreads)
    conv_bwd_w_kernel(const TX* __restrict__ x,
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
    const TX* x_img = x + (size_t)img * c * h * wd;
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
          v = dl4j::to_f32(x_img[((size_t)col_ci[i] * h + iy) * wd + ix]);
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

// --- conv_bwd_data, resident route -------------------------------------------

constexpr int kResidentMaxThreads = 1024;
constexpr int kResidentMaxGroup = 32;  // channels of a block

// Shared-memory floats of a resident block (the formula of
// ops/conv_block.py resident_smem_bytes): the gradient map, padded so
// the weights after it start 16-byte aligned; the group's weights,
// kh*kw*o for each channel of the group padded to 4; one dx tile of the
// group for each tap group.
long long resident_g_floats(int o, int oh, int ow) {
  return ((long long)o * oh * ow + 3) / 4 * 4;
}
long long resident_floats(int h, int wd, int o, int kh, int kw, int oh,
                          int ow, int group, int tap_groups) {
  const long long cgp = (group + 3) / 4 * 4;
  return resident_g_floats(o, oh, ow) + (long long)kh * kw * o * cgp +
         tap_groups * cgp * h * wd;
}
// threads of a tap group: one an item (channel quad, gradient pixel),
// whole warps, at most a block
int resident_per_group(int group, int oh, int ow) {
  const long long items = (long long)(group + 3) / 4 * oh * ow;
  const long long per = (items + 31) / 32 * 32;
  return per < kResidentMaxThreads ? (int)per : kResidentMaxThreads;
}

// The weights of every channel group, transposed for the resident
// blocks: wt[grp][tap][oc][j] = w[oc][grp*group + j][tap], zero for j
// past the layer's channels or the group (j < 4 * ceil(group / 4)).
// One pass over the weights a call, so a block stages its group's
// slice in 16-byte copies without an index division.
__global__ void transpose_weights_kernel(const float* __restrict__ w,
                                         float* __restrict__ wt, int c,
                                         int o, int khw, int group,
                                         long long total) {
  const int cgp = (group + 3) / 4 * 4;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const int j = (int)(i % cgp);
    long long r = i / cgp;
    const int oc = (int)(r % o);
    r /= o;
    const int tap = (int)(r % khw);
    const int ci = (int)(r / khw) * group + j;
    wt[i] = (j < group && ci < c) ? w[((size_t)oc * c + ci) * khw + tap]
                                  : 0.0f;
  }
}

// Block (img, channel group): dx[img, c0 + j, :, :] for the group's cn
// channels. Per tap (dh, dw), dx[:, iy, ix] += w[:, :, dh, dw]^T g[:, oy,
// ox] with (iy, ix) = (oy*sh - ph + dh, ox*sw - pw + dw): a [4 x o] by
// [o x 1] product for each item (channel quad q, gradient pixel p), its
// sum added to a dx tile in shared memory. The block's threads form
// tap_groups groups, each taking a contiguous run of the taps into a dx
// tile of its own. Within a tap no two items touch one dx element, and
// a barrier separates a group's taps, so no element is updated twice at
// once; the end adds the groups' tiles in order. So each element sums
// its taps and each tap's o products in a fixed order: two launches give
// the same bits.
// Shared memory: g_s [o][oh*ow] (g_floats), w_s [tap][oc][cq] float4,
// dx_s [tap_groups][4*cq][h*w].
__global__ void __launch_bounds__(kResidentMaxThreads)
    conv_bwd_data_resident_kernel(const float* __restrict__ dacc,
                                  const float* __restrict__ wt,
                                  float* __restrict__ dx, int c, int h,
                                  int wd, int o, int kh, int kw, int sh,
                                  int sw, int ph, int pw, int oh, int ow,
                                  int group, int tap_groups, int g_floats) {
  extern __shared__ __align__(16) float smem[];
  const int cq = (group + 3) / 4;
  const int cgp = 4 * cq;
  const int khw = kh * kw;
  const int ohw = oh * ow;
  const int hw = h * wd;
  float* g_s = smem;
  float* w_f = smem + g_floats;
  float* dx_s = w_f + (size_t)khw * o * cgp;
  const int img = blockIdx.x;
  const int c0 = blockIdx.y * group;
  const int cn = min(group, c - c0);
  const int nt = blockDim.x;
  const int tid = threadIdx.x;

  // the image's gradient, contiguous in dacc, and the group's weights,
  // contiguous in wt
  const float* g_src = dacc + (size_t)img * o * ohw;
  const int g_len = o * ohw;
  if ((g_len & 3) == 0 && (reinterpret_cast<uintptr_t>(g_src) & 15) == 0) {
    for (int i = tid; i < g_len / 4; i += nt)
      dl4j::cp_async16(g_s + 4 * i, g_src + 4 * i, 16);
  } else {
    for (int i = tid; i < g_len; i += nt)
      dl4j::cp_async4(g_s + i, g_src + i, 4);
  }
  const float* w_src = wt + (size_t)blockIdx.y * khw * o * cgp;
  for (int i = tid; i < khw * o * cq; i += nt)
    dl4j::cp_async16(w_f + 4 * i, w_src + 4 * i, 16);
  for (int i = tid; i < tap_groups * cgp * hw; i += nt) dx_s[i] = 0.0f;
  dl4j::cp_async_commit();
  dl4j::cp_async_wait<0>();
  __syncthreads();

  const float4* w_s = reinterpret_cast<const float4*>(w_f);
  const int per = nt / tap_groups;  // threads of a tap group
  const int tg = tid / per;
  const int lt = tid - tg * per;
  const int tap_lo = tg * khw / tap_groups;
  const int tap_hi = (tg + 1) * khw / tap_groups;
  const int steps = (khw + tap_groups - 1) / tap_groups;
  float* dx_g = dx_s + (size_t)tg * cgp * hw;
  const int items = cq * ohw;  // lanes: consecutive pixels of one quad
  for (int s = 0; s < steps; ++s) {
    const int tap = tap_lo + s;
    if (tap < tap_hi) {
      const int dh = tap / kw;
      const int dw = tap - dh * kw;
      const float4* w_tap = w_s + (size_t)tap * o * cq;
      for (int it = lt; it < items; it += per) {
        const int q = it / ohw;
        const int p = it - q * ohw;
        const int oy = p / ow;
        const int iy = oy * sh - ph + dh;
        const int ix = (p - oy * ow) * sw - pw + dw;
        if (iy < 0 || iy >= h || ix < 0 || ix >= wd) continue;  // padding
        const float* gp = g_s + p;
        const float4* wp = w_tap + q;
        float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll 4
        for (int oc = 0; oc < o; ++oc) {
          const float gv = gp[oc * ohw];
          const float4 wv = wp[oc * cq];
          a0 = fmaf(wv.x, gv, a0);
          a1 = fmaf(wv.y, gv, a1);
          a2 = fmaf(wv.z, gv, a2);
          a3 = fmaf(wv.w, gv, a3);
        }
        float* d = dx_g + (size_t)(4 * q) * hw + iy * wd + ix;
        d[0] += a0;
        d[hw] += a1;
        d[2 * hw] += a2;
        d[3 * hw] += a3;
      }
    }
    __syncthreads();  // the next tap adds to other threads' elements
  }

  float* dst = dx + ((size_t)img * c + c0) * hw;
  for (int i = tid; i < cn * hw; i += nt) {
    float v = dx_s[i];
    for (int t = 1; t < tap_groups; ++t) v += dx_s[(size_t)t * cgp * hw + i];
    dst[i] = v;
  }
}

int launch_resident(const float* dacc, const float* w, float* wt, float* dx,
                    int n, int c, int h, int wd, int o, int kh, int kw,
                    int sh, int sw, int ph, int pw, int oh, int ow,
                    int group, int tap_groups, int g_floats, int smem_bytes,
                    cudaStream_t stream) {
  static unsigned smem_set = 0;  // devices whose cap is raised
  int rc = dl4j::allow_dynamic_smem(conv_bwd_data_resident_kernel,
                                    dl4j::kMaxSmemBytes, &smem_set);
  if (rc != 0) return rc;
  const int groups = dl4j::ceil_div(c, group);
  const long long total =
      (long long)groups * kh * kw * o * ((group + 3) / 4 * 4);
  long long blocks = (total + 255) / 256;
  if (blocks > 4 * dl4j::kSmCount) blocks = 4 * dl4j::kSmCount;
  transpose_weights_kernel<<<(unsigned)blocks, 256, 0, stream>>>(
      w, wt, c, o, kh * kw, group, total);
  rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int threads = tap_groups * resident_per_group(group, oh, ow);
  dim3 grid((unsigned)n, (unsigned)groups);
  conv_bwd_data_resident_kernel<<<grid, threads, smem_bytes, stream>>>(
      dacc, wt, dx, c, h, wd, o, kh, kw, sh, sw, ph, pw, oh, ow, group,
      tap_groups, g_floats);
  return (int)cudaGetLastError();
}

// --- conv_bwd_w, image-resident route ----------------------------------------

constexpr int kDwMaxThreads = 384;
constexpr int kDwMaxK = 5;  // square kernels up to 5 x 5
constexpr int kDwFinishThreads = 256;  // 8 warps: chunk strides of 8

// Shared-memory layout of an image-resident dW block (the formula of
// ops/conv_block.py bwd_w_smem_bytes). A staging buffer holds an image's
// x slab for the channel group, each channel at an odd stride (so the
// lanes of a warp, on consecutive channels, hit distinct banks), then its
// gradient map, each output channel at a stride of its map padded to 16
// bytes plus 16 (so the two output quads of a warp hit other banks).
// Two buffers; after the image loop the same memory holds the pixel
// groups' partial sums (if more than one: pixel_groups x items x 4 x k),
// or else the block's dW slice (o x group x k x k).
__host__ __device__ inline int dw_x_stride(int h, int wd) {
  return (h * wd) | 1;
}
__host__ __device__ inline int dw_g_stride(int oh, int ow) {
  return (oh * ow + 3) / 4 * 4 + 4;
}
__host__ __device__ inline long long dw_x_floats(int group, int h, int wd) {
  return ((long long)group * dw_x_stride(h, wd) + 3) / 4 * 4;
}
__host__ __device__ inline long long dw_stage_floats(int group, int h,
                                                     int wd, int o, int oh,
                                                     int ow) {
  return dw_x_floats(group, h, wd) + (long long)o * dw_g_stride(oh, ow);
}
// items: (output-channel quad, tap row, channel)
__host__ __device__ inline long long dw_items(int o, int group, int k) {
  return (long long)((o + 3) / 4) * k * group;
}
long long dw_floats(int group, int h, int wd, int o, int oh, int ow, int k,
                    int pixel_groups) {
  const long long stage = 2 * dw_stage_floats(group, h, wd, o, oh, ow);
  if (pixel_groups == 1) {  // the block's dW slice, staged for the store
    const long long out = (long long)o * group * k * k;
    return stage > out ? stage : out;
  }
  const long long red =
      (long long)pixel_groups * dw_items(o, group, k) * 4 * k;
  return stage > red ? stage : red;
}

// acc[j][e] += g[j] * win[e]: one gradient pixel of 4 output channels
// against the K inputs of one tap row under it
template <int K>
__device__ __forceinline__ void dw_fma(float (&acc)[4][K],
                                       const float (&g)[4],
                                       const float (&win)[K]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < K; ++e) acc[j][e] = fmaf(g[j], win[e], acc[j][e]);
}

// Block (chunk of images, channel group): dW[oc, c0 + ci, dh, :] summed
// over the chunk's images, into partial[chunk] (or dw for one chunk).
// An item is (output-channel quad oq, tap row dh, channel ci), channels
// fastest across a warp's lanes: its thread holds the 4 x K sums in
// registers and walks its pixel group's gradient rows; along a row it
// slides a K-wide window over the input row under it (stride 1: one new
// shared load a pixel), so one pixel costs 4 gradient loads (broadcasts)
// and 1 input load for 4 K FMAs, and no product falls outside the map.
// Images are staged whole (x slab and gradient map) by cp.async, the
// next one in flight while this one is summed. Pixel groups (runs of
// gradient rows) add their sums in order at the end, so every dW entry
// sums its images, rows and pixels in a fixed order: two launches give
// the same bits. (A thread holding all K tap rows, 4 K^2 sums and K
// input loads a pixel, ran slower at LeNet's conv2 on an H100: 164
// registers left 9 warps an SM.) x is TX (f32, bf16 or f16); the slab
// is f32 in shared memory either way: a half image is loaded, converted
// and stored as it is staged (synchronously, into the buffer the last
// barrier freed), an f32 one copied by cp.async.
template <int K, typename TX>
__global__ void __launch_bounds__(kDwMaxThreads, 2)
    conv_bwd_w_resident_kernel(const TX* __restrict__ x,
                               const float* __restrict__ dacc,
                               float* __restrict__ dw,
                               float* __restrict__ partial, int n, int c,
                               int h, int wd, int o, int sh, int sw, int ph,
                               int pw, int oh, int ow, int group,
                               int pixel_groups, int images_per_chunk) {
  extern __shared__ __align__(16) float smem[];
  const int hw = h * wd;
  const int ohw = oh * ow;
  const int xs_stride = dw_x_stride(h, wd);
  const int gs_stride = dw_g_stride(oh, ow);
  const int x_floats = (int)dw_x_floats(group, h, wd);
  const int stage_len = x_floats + o * gs_stride;
  const int c0 = blockIdx.y * group;
  const int cn = min(group, c - c0);
  const int img0 = blockIdx.x * images_per_chunk;
  const int cnt = min(n - img0, images_per_chunk);
  const int items = (o + 3) / 4 * K * group;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int pg = tid / items;  // pixel group
  const int it = tid - pg * items;
  const int oq = it / (K * group);
  const int dh = (it - oq * K * group) / group;
  const int ci = it - (oq * K + dh) * group;
  const bool active = pg < pixel_groups && ci < cn;
  const int oy_lo = pg * oh / pixel_groups;
  const int oy_hi = (pg + 1) * oh / pixel_groups;
  // the quad's channels, clamped to the last real one (its sums dropped)
  int g_off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) g_off[j] = min(4 * oq + j, o - 1) * gs_stride;

  float acc[4][K];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < K; ++e) acc[j][e] = 0.0f;

  const bool g_vec = (ohw & 3) == 0 &&
                     (reinterpret_cast<uintptr_t>(dacc) & 15) == 0;
  auto stage = [&](int img, int buf) {
    float* xs = smem + (size_t)buf * stage_len;
    const TX* x_src = x + ((size_t)img * c + c0) * hw;
    for (int i = tid; i < cn * hw; i += nt) {
      const int ch = i / hw;
      if constexpr (std::is_same_v<TX, float>)
        dl4j::cp_async4(xs + ch * xs_stride + (i - ch * hw), x_src + i, 4);
      else
        xs[ch * xs_stride + (i - ch * hw)] = dl4j::to_f32(x_src[i]);
    }
    float* gs = xs + x_floats;
    const float* g_src = dacc + (size_t)img * o * ohw;
    if (g_vec) {
      const int q4 = ohw / 4;
      for (int i = tid; i < o * q4; i += nt) {
        const int ch = i / q4;
        dl4j::cp_async16(gs + ch * gs_stride + 4 * (i - ch * q4),
                         g_src + 4 * i, 16);
      }
    } else {
      for (int i = tid; i < o * ohw; i += nt) {
        const int ch = i / ohw;
        dl4j::cp_async4(gs + ch * gs_stride + (i - ch * ohw), g_src + i, 4);
      }
    }
    dl4j::cp_async_commit();
  };
  stage(img0, 0);
  for (int i = 0; i < cnt; ++i) {
    if (i + 1 < cnt) {
      stage(img0 + i + 1, (i + 1) & 1);
      dl4j::cp_async_wait<1>();
    } else {
      dl4j::cp_async_wait<0>();
    }
    __syncthreads();
    if (active) {
      const float* xs = smem + (size_t)(i & 1) * stage_len;
      const float* x_ch = xs + ci * xs_stride;
      const float* gs = xs + x_floats;
      for (int oy = oy_lo; oy < oy_hi; ++oy) {
        const int iy = oy * sh - ph + dh;
        if (iy < 0 || iy >= h) continue;  // the row lies on the padding
        const float* x_row = x_ch + iy * wd;
        const float* g_row = gs + oy * ow;
        float win[K];
        float g[4];
        if (sw == 1) {
          win[0] = 0.0f;
#pragma unroll
          for (int e = 0; e < K - 1; ++e) {
            const int ix = e - pw;
            win[e + 1] = ix >= 0 && ix < wd ? x_row[ix] : 0.0f;
          }
#pragma unroll 4
          for (int ox = 0; ox < ow; ++ox) {
#pragma unroll
            for (int e = 0; e < K - 1; ++e) win[e] = win[e + 1];
            const int ix = ox - pw + K - 1;
            win[K - 1] = ix >= 0 && ix < wd ? x_row[ix] : 0.0f;
#pragma unroll
            for (int j = 0; j < 4; ++j) g[j] = g_row[g_off[j] + ox];
            dw_fma<K>(acc, g, win);
          }
        } else {
          for (int ox = 0; ox < ow; ++ox) {
#pragma unroll
            for (int e = 0; e < K; ++e) {
              const int ix = ox * sw - pw + e;
              win[e] = ix >= 0 && ix < wd ? x_row[ix] : 0.0f;
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) g[j] = g_row[g_off[j] + ox];
            dw_fma<K>(acc, g, win);
          }
        }
      }
    }
    __syncthreads();  // the next stage overwrites this buffer
  }

  constexpr int kPerItem = 4 * K;
  float* dst = partial != nullptr
                   ? partial + (size_t)blockIdx.x * o * c * K * K
                   : dw;
  if (pixel_groups == 1) {
    // the block's dW slice [o][cn][K][K] through shared memory, so the
    // stores to device memory are whole runs (oc's cn * K * K entries
    // are contiguous there) instead of a lane's 4 * K scattered ones
    float* out_s = smem;
    if (active) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int oc = 4 * oq + j;
        if (oc >= o) continue;
        float* d = out_s + (((size_t)oc * cn + ci) * K + dh) * K;
#pragma unroll
        for (int e = 0; e < K; ++e) d[e] = acc[j][e];
      }
    }
    __syncthreads();
    const int run = cn * K * K;
    for (int idx = tid; idx < o * run; idx += nt) {
      const int oc = idx / run;
      dst[((size_t)oc * c + c0) * K * K + (idx - oc * run)] = out_s[idx];
    }
    return;
  }
  // pixel groups: every thread parks its sums, then each (item, j, tap)
  // adds the groups in order (the staging buffers are free: the loop
  // ended on a barrier after its last wait)
  float* red = smem;
  if (pg < pixel_groups) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < K; ++e)
        red[(size_t)tid * kPerItem + j * K + e] = acc[j][e];
  }
  __syncthreads();
  for (int idx = tid; idx < items * kPerItem; idx += nt) {
    const int item = idx / kPerItem;
    const int jt = idx - item * kPerItem;
    const int q = item / (K * group);
    const int row = (item - q * K * group) / group;
    const int cc = item - (q * K + row) * group;
    const int oc = 4 * q + jt / K;
    if (cc >= cn || oc >= o) continue;
    float v = 0.0f;
    for (int p = 0; p < pixel_groups; ++p)
      v += red[((size_t)p * items + item) * kPerItem + jt];
    dst[(((size_t)oc * c + c0 + cc) * K + row) * K + jt % K] = v;
  }
}

// out[i] = the sum over chunks z of partial[z][i]: warp w of a block
// adds z = w, w + 8, ... in order, then the 8 warp sums are added in
// order. A fixed order, so the same bits every launch, with eight loads
// of an element in flight where the split-K finish has one: the chunks
// are many and dW small.
__global__ void __launch_bounds__(kDwFinishThreads)
    dw_finish_kernel(const float* __restrict__ partial, int chunks,
                     long long total, float* __restrict__ out) {
  constexpr int kWarps = kDwFinishThreads / 32;
  __shared__ float sums[kWarps][32];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const long long i = (long long)blockIdx.x * 32 + lane;
  float z = 0.0f;
  if (i < total) {
#pragma unroll 4
    for (int s = warp; s < chunks; s += kWarps)
      z += partial[(size_t)s * total + i];
  }
  sums[warp][lane] = z;
  __syncthreads();
  if (warp == 0 && i < total) {
    float v = sums[0][lane];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) v += sums[w][lane];
    out[i] = v;
  }
}

template <int K, typename TX>
int launch_dw_resident(const TX* x, const float* dacc, float* dw,
                       float* partial, int n, int c, int h, int wd, int o,
                       int sh, int sw, int ph, int pw, int oh, int ow,
                       int group, int pixel_groups, int images_per_chunk,
                       int chunks, int threads, int smem_bytes,
                       cudaStream_t stream) {
  static unsigned smem_set = 0;  // devices whose cap is raised
  int rc = dl4j::allow_dynamic_smem(conv_bwd_w_resident_kernel<K, TX>,
                                    dl4j::kMaxSmemBytes, &smem_set);
  if (rc != 0) return rc;
  dim3 grid((unsigned)chunks, (unsigned)dl4j::ceil_div(c, group));
  conv_bwd_w_resident_kernel<K, TX><<<grid, threads, smem_bytes, stream>>>(
      x, dacc, dw, chunks > 1 ? partial : nullptr, n, c, h, wd, o, sh, sw,
      ph, pw, oh, ow, group, pixel_groups, images_per_chunk);
  rc = (int)cudaGetLastError();
  if (rc != 0 || chunks == 1) return rc;
  const long long total = (long long)o * c * K * K;
  dw_finish_kernel<<<(unsigned)((total + 31) / 32), kDwFinishThreads, 0,
                     stream>>>(partial, chunks, total, dw);
  return (int)cudaGetLastError();
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

// dL/dx (f32) on the resident route: `group` input channels a block,
// `tap_groups` groups of its threads (ops/conv_block.py
// conv_bwd_data_route picks both); `wt` is a scratch of
// ceil(c / group) * kh * kw * o * 4 * ceil(group / 4) f32 for the
// transposed weights. Returns the cudaError_t of the launches (0 on
// success); a group above 32 channels, more threads than a block takes
// or a working set above the H100's 227 KB of shared memory a block is
// refused (cudaErrorInvalidValue), never shrunk.
extern "C" int dl4j_conv_bwd_data_resident(const void* dacc, const void* w,
                                           void* wt, void* dx, int n, int c,
                                           int h, int wd, int o, int kh,
                                           int kw, int sh, int sw, int ph,
                                           int pw, int oh, int ow, int group,
                                           int tap_groups, void* stream) {
  if (bad_geometry(n, c, h, wd, o, kh, kw, sh, sw, ph, pw, oh, ow) ||
      group <= 0 || group > kResidentMaxGroup ||
      dl4j::ceil_div(c, group) > 65535 || tap_groups <= 0 ||
      tap_groups > kh * kw ||
      (long long)tap_groups * resident_per_group(group, oh, ow) >
          kResidentMaxThreads)
    return (int)cudaErrorInvalidValue;
  const long long g_floats = resident_g_floats(o, oh, ow);
  const long long smem =
      4 * resident_floats(h, wd, o, kh, kw, oh, ow, group, tap_groups);
  if (smem > dl4j::kMaxSmemBytes) return (int)cudaErrorInvalidValue;
  return launch_resident(
      static_cast<const float*>(dacc), static_cast<const float*>(w),
      static_cast<float*>(wt), static_cast<float*>(dx), n, c, h, wd, o, kh,
      kw, sh, sw, ph, pw, oh, ow, group, tap_groups, (int)g_floats,
      (int)smem, static_cast<cudaStream_t>(stream));
}

// The number of k chunks for dL/dx (1: no split); the wrapper allocates
// an f32 scratch of splits * n * c * h * w when it is > 1.
extern "C" int dl4j_conv_bwd_data_splits(int n, int c, int h, int wd, int o,
                                         int kh, int kw) {
  if (n <= 0 || c <= 0 || h <= 0 || wd <= 0) return 1;
  return dl4j::plan_splits(data_tiles(n, c, h, wd), o * kh * kw);
}

// dL/dx (f32) on the gemm route. Returns the cudaError_t of the launches
// (0 on success).
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

// dL/dW (f32, OIHW) from x of `x_dtype` (enum DType) and the f32 dacc.
// Returns the cudaError_t of the launches.
extern "C" int dl4j_conv_bwd_w(const void* x, const void* dacc, void* dw,
                               void* partial, int x_dtype, int n, int c,
                               int h, int wd,
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
  const float* g = static_cast<const float*>(dacc);
  float* part = z > 1 ? ws : nullptr;
#define DL4J_DW_GEMM(TX)                                                   \
  conv_bwd_w_kernel<TX><<<grid, kThreads, 0, st>>>(                        \
      static_cast<const TX*>(x), g, out, part, n, c, h, wd, o, kh, kw, sh, \
      sw, ph, pw, oh, ow, r_chunk);
  switch (x_dtype) {
    case dl4j::kF32:
      DL4J_DW_GEMM(float)
      break;
    case dl4j::kBF16:
      DL4J_DW_GEMM(__nv_bfloat16)
      break;
    case dl4j::kF16:
      DL4J_DW_GEMM(__half)
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DL4J_DW_GEMM
  const int rc = (int)cudaGetLastError();
  if (rc != 0 || z == 1) return rc;
  return dl4j::launch_splitk_finish<float>(ws, z, (long long)o * k2_len,
                                           nullptr, nullptr, 1, 1,
                                           dl4j::kIdentity, out, st);
}

// dL/dW (f32, OIHW) on the image-resident route: `group` input channels
// a block, `pixel_groups` runs of gradient rows a block's threads split,
// `images_per_chunk` images a block (ops/conv_block.py conv_bwd_w_route
// picks all three); `partial` is a scratch of chunks * o * c * kh * kw
// f32, chunks = ceil(n / images_per_chunk), needed when chunks > 1.
// Returns the cudaError_t of the launches (0 on success); a kernel that
// is not square or above 5 x 5, more threads than 384 or a working set
// above the H100's 227 KB of shared memory a block is refused
// (cudaErrorInvalidValue), never shrunk.
extern "C" int dl4j_conv_bwd_w_resident(const void* x, const void* dacc,
                                        void* dw, void* partial, int x_dtype,
                                        int n, int c, int h, int wd, int o,
                                        int kh,
                                        int kw, int sh, int sw, int ph,
                                        int pw, int oh, int ow, int group,
                                        int pixel_groups,
                                        int images_per_chunk, void* stream) {
  if (bad_geometry(n, c, h, wd, o, kh, kw, sh, sw, ph, pw, oh, ow) ||
      kh != kw || kw > kDwMaxK || group <= 0 || group > c ||
      dl4j::ceil_div(c, group) > 65535 || pixel_groups <= 0 ||
      pixel_groups > oh || images_per_chunk <= 0 ||
      (long long)n * c * h * wd > 0x7fffffffLL ||
      (long long)n * o * oh * ow > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const long long threads =
      (dw_items(o, group, kw) * pixel_groups + 31) / 32 * 32;
  const long long smem =
      4 * dw_floats(group, h, wd, o, oh, ow, kw, pixel_groups);
  const int chunks = dl4j::ceil_div(n, images_per_chunk);
  if (threads > kDwMaxThreads || smem > dl4j::kMaxSmemBytes ||
      (chunks > 1 && partial == nullptr))
    return (int)cudaErrorInvalidValue;
  const float* gp = static_cast<const float*>(dacc);
  float* out = static_cast<float*>(dw);
  float* ws = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DL4J_DW_RESIDENT(K, TX)                                              \
  case K:                                                                    \
    return launch_dw_resident<K, TX>(                                        \
        static_cast<const TX*>(x), gp, out, ws, n, c, h, wd, o, sh, sw, ph,  \
        pw, oh, ow, group, pixel_groups, images_per_chunk, chunks,           \
        (int)threads, (int)smem, st);
#define DL4J_DW_RESIDENT_KS(TX) \
  switch (kw) {                 \
    DL4J_DW_RESIDENT(1, TX)     \
    DL4J_DW_RESIDENT(2, TX)     \
    DL4J_DW_RESIDENT(3, TX)     \
    DL4J_DW_RESIDENT(4, TX)     \
    DL4J_DW_RESIDENT(5, TX)     \
    default:                    \
      return (int)cudaErrorInvalidValue; \
  }
  switch (x_dtype) {
    case dl4j::kF32:
      DL4J_DW_RESIDENT_KS(float)
    case dl4j::kBF16:
      DL4J_DW_RESIDENT_KS(__nv_bfloat16)
    case dl4j::kF16:
      DL4J_DW_RESIDENT_KS(__half)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef DL4J_DW_RESIDENT_KS
#undef DL4J_DW_RESIDENT
}
