// Fused paste + depth-aware alpha composite for SPAIR as a four-tap paste
// from the sample coordinates, forward and backward.
//
// Replaces the Pallas TPU kernel pair in
// split_vae_tpu/ops/pallas/render_packed.py (_fwd_kernel, _bwd_kernel) and
// its unpacked twin render_fused.py. Those take dense interpolation matrices
// wy [B,K,H,h] and wx [B,K,W,w] and multiply them out on the MXU. Every row of
// wy and wx holds at most two non-zeros, so this pair takes the paste's sample
// coordinates ys [B,K,H] and xs [B,K,W] (in object pixels) instead and reads
// four taps a canvas pixel: one pair for any h, w, H, W and K, and any C
// from 1 to kMaxChannels = 8 (C = 1 and 3 unrolled with 8- and 16-byte pixel
// accesses, any other C in a loop of scalar loads; paste_taps.cuh).
//
// The function. Per image b and cell k (channel last, as the JAX package):
//   taps of u on an axis of n object pixels, interp_matrix's in fp32:
//     x0 = floor(u); i0 = clamp(x0, 0, n-1); i1 = clamp(x0 + 1, 0, n-1)
//     w0 = i1 - u (weight on i0), w1 = u - i0 (weight on i1); both 0 where
//     i0 == i1 (u in (-1, 0), u >= n-1 or further out: the dense row is
//     (i - u) + (u - i) = 0 exactly there, and so is its gradient)
//   paste_c = sum_{a,e} wy_a[y] wx_e[x] obj[iy_a, jx_e, c]             [H, W]
//   alpha   = clip(paste_C, 1e-8, 1)
//   rgb_c   = clip(paste_c + noise_scale * N(0,1), 0, 1)
//   imp     = z_pres * alpha * depth_w
//   S1_c += imp * rgb_c;  S2 += imp;  S3 += z_pres * alpha * imp
//   out_c = (S3/D) * (S1/D) + (1 - S3/D) * bg_c,   D = S2 + 1e-8
// Gradients, as autograd finds them through interp_matrix and the dense
// paste (floor and clamp carry none; d w0/du = -1, d w1/du = +1), with gp the
// gradient of the paste:
//   g_ys[y] = sum_{x,c} gp[y,x,c] sum_e wx_e[x] (obj[iy_1, jx_e, c] - obj[iy_0, jx_e, c])
//   g_xs[x] = sum_{y,c} gp[y,x,c] sum_a wy_a[y] (obj[iy_a, jx_1, c] - obj[iy_a, jx_0, c])
//   g_obj   = the transpose of the gather.
// The dense g_wy and g_wx are never formed.
//
// The noise is Philox-4x32-10 (philox.cuh) keyed by (seed + b) with the
// element's position ((k*C + c)*H + y)*W + x as the counter, the field of the
// render_noise kernel below and of the row-windowed render.
//
// What bounds it on an H100 SXM (LG-SPAIR config #5: B=256, K=16, 32-px
// objects with 3+1 channels, 48-px canvases, fp32): the noise. Each call
// draws B*K*C*H*W = 28.3 M normals, and one normal_at is 111 instructions a
// lane on its fast path (sm_90a SASS, counted in chip_smoke.py beside
// NORMAL_INSTRUCTIONS): 3.14 G lane instructions, 0.094 ms at one a lane a
// clock on 132 SMs x 128 lanes at 1.98 GHz, against ~57 MB (forward) and
// ~133 MB (backward) of bytes, 17 and 40 us at 3.35 TB/s (of the 67 MB of
// objects, random boxes' taps read ~30 MB of 32-byte sectors), and 0.25 /
// 0.39 GFLOP of arithmetic, 4 and 6 us. The render_noise kernel alone, which
// writes the same normals, takes about twice the noise term: the integer
// multiplies and conversions issue at a fraction of the FP32 rate.
//
// Design:
//   - Forward: a thread a canvas pixel, a block `rows` canvas rows of one
//     image (the wrapper's ROWS_PER_BLOCK, from a sweep in chip_smoke.py). The
//     thread walks the K cells in order with its C+2 sums in registers; where
//     its row and column taps both lie in the object it reads the four taps,
//     one 16-byte load each (C+1 = 4 floats a pixel), straight from device
//     memory: a paste reads at most the box's footprint of the object (the
//     box is at most a quarter of the canvas a side), so staging whole objects
//     in shared memory would move more bytes, not fewer. The paste repeats the
//     dense einsums' roundings: rows first (the i0 term a product, the i1 term
//     an FMA onto it), then columns the same way. The forward also writes the
//     sums S1, S2, S3 of every pixel (C+2 planes an image) for the backward,
//     which then needs no pass that rebuilds them.
//   - Backward: a block takes `cpb` cells of one image (CELLS_PER_BLOCK). It
//     first forms the composite's gradients of every pixel of the image from
//     the saved sums, in shared memory (C+2 planes; the image's first block
//     also writes g_bg). Then, a cell at a time: the taps of the H rows and W
//     columns into shared memory; a thread a pixel recomputes the paste and
//     the noise once, forms gp (C+1 values, kept in shared memory) and its
//     pixel's parts of g_ys and g_xs, and sums g_zp, g_wd. Then, with no
//     atomics and in a fixed order: a thread an object pixel (i, j) gathers
//     g_obj over the canvas rows and columns that tap it (contiguous ranges:
//     the coordinates are monotone in the canvas index), columns first, then
//     rows; a thread a canvas row sums g_ys over x in order, a thread a
//     column g_xs over y. Two runs give bit-equal results.
//
// The bodies (render_fwd_kernel, render_bwd_kernel) live in paste_taps.cuh,
// shared with the row-windowed render; this source instantiates them without
// the band (kBanded = false). Built with nvcc for sm_90a into a shared library
// with a plain C interface (split_vae_torch/kernels/render.py loads it with
// ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "paste_taps.cuh"
#include "philox.cuh"

namespace {

__global__ void render_noise_kernel(const int* __restrict__ seed, float* __restrict__ out,
                                    int per_image, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int b = (int)(e / per_image), pos = (int)(e % per_image);
  out[e] = normal_at((uint32_t)seed[0] + (uint32_t)b, (uint32_t)pos);
}

}  // namespace

extern "C" {

const char* render_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// objs [B,K,h,w,C+1], ys [B,K,H], xs [B,K,W], zp/wd [B,K], bg/out [B,H,W,C],
// sums [B,C+2,H,W] (S1 planes, S2, S3: written for the backward); seed: one
// int32 in device memory; `rows` canvas rows a block (at most 512 threads).
// Returns the launch's cudaError_t.
int render_fwd(const float* objs, const float* ys, const float* xs, const float* zp,
               const float* wd, const float* bg, const int* seed, float noise_scale, float* out,
               float* sums, int B, int K, int h, int w, int H, int W, int C, int rows,
               void* stream) {
  return render_fwd_any<false>(objs, ys, xs, zp, wd, bg, seed, noise_scale, out, sums, B, K, h,
                               w, H, W, C, rows, stream);
}

// sums: the forward's; g [B,H,W,C] -> g_objs, g_ys, g_xs, g_zp, g_wd, g_bg
// shaped as their inputs; `cpb` cells a block.
int render_bwd(const float* objs, const float* ys, const float* xs, const float* zp,
               const float* wd, const float* bg, const int* seed, float noise_scale,
               const float* sums, const float* g, float* g_objs, float* g_ys, float* g_xs,
               float* g_zp, float* g_wd, float* g_bg, int B, int K, int h, int w, int H, int W,
               int C, int cpb, void* stream) {
  return render_bwd_any<false>(objs, ys, xs, zp, wd, bg, seed, noise_scale, sums, g, g_objs,
                               g_ys, g_xs, g_zp, g_wd, g_bg, B, K, h, w, H, W, C, cpb, stream);
}

// out [B,K,C,H,W]: the standard normals the kernels add (before noise_scale).
int render_noise(const int* seed, float* out, int B, int K, int C, int H, int W, void* stream) {
  const int per_image = K * C * H * W;
  const long long total = (long long)B * per_image;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  render_noise_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(seed, out, per_image, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
