// Row-windowed fused paste + depth-aware alpha composite as a banded four-tap
// paste from the sample coordinates, forward and backward.
//
// Replaces the Pallas TPU kernel pair in tools/pallas_research/render_windowed.py
// (_fwd_kernel, _bwd_kernel). The function is render.cu's, with every per-cell
// term confined to the cell's row band [start, end) of the canvas and the rows
// outside it, where the paste is exactly zero and so
// alpha = clip(0, 1e-8, 1) = 1e-8, taken in closed form:
//
//   S1_c += band(imp * rgb_c)
//   S2   += band(imp - z*wd*1e-8)               + sum_k z_k*wd_k*1e-8
//   S3   += band(z*alpha*imp - z^2*wd*1e-16)    + sum_k z_k^2*wd_k*1e-16
//   out_c = (S3/D) * (S1_c/D) + (1 - S3/D) * bg_c,   D = S2 + 1e-8
//
// Two labelled deviations from the full-canvas kernel, both far below fp32
// resolution of the result: the render noise is drawn only inside the band
// (outside, it would add clip(N(0, s), 0, 1) * 1e-8 * z * wd), and the
// backward keeps the 1e-8-scale terms of g_z_pres and g_depth_w outside the
// band through the full-canvas sums of g_S2 and g_S3 and drops 1e-16 cross
// terms.
//
// The band (kernels/render_windowed.py::compute_bands's rule, found in the
// kernel by one warp a cell, paste_taps.cuh::find_band): a canvas row y is
// supported where its sample coordinate ys[y] lies in (-1, h); the band is
// [first - 1, last + 2) clipped to the canvas, first and last the first and
// last supported rows, and empty where no row is supported. Outside the band both taps of a
// row coincide, so its paste and every gradient of it are exactly zero. The
// taps are render.cu's (paste_taps.cuh::make_tap); any h, w, H, W, K and any
// C from 1 to kMaxChannels (C = 1 and 3 unrolled).
//
// What bounds it on an H100 SXM (LG-SPAIR config #5: B=256, K=16, 32-px
// objects with 3+1 channels, 48-px canvases, fp32): the noise (forward) and
// bytes (backward). The pair moves the full pair's bytes (~57 MB forward,
// ~133 MB backward: 17 and 40 us at 3.35 TB/s) but draws the Philox noise
// only on the band rows, 12.5 of 48 a cell with random boxes: 7.4 M normals,
// ~25 us at one instruction a lane a clock, where the full pair draws 28.3 M
// (94 us). chip_smoke.py::windowed_bounds has the three terms; PERF.md the
// measured times.
//
// Design, render.cu's restricted to the band (the bodies in paste_taps.cuh,
// instantiated here with kBanded = true):
//   - Forward: a thread a canvas pixel, `rows` canvas rows of one image a
//     block (the wrapper's ROWS_PER_BLOCK). The block's warps first find the
//     bands of the image's K cells (a ballot a 32 rows) into shared memory.
//     Each thread walks the cells in order with its C+2 sums in registers:
//     inside a cell's band it reads the four taps straight from device memory
//     and draws the noise; outside it adds nothing, and the closed-form
//     constants are added once at the end. It writes the sums S1, S2, S3
//     (C+2 planes an image) for the backward.
//   - Backward: a block takes `cpb` cells of one image (CELLS_PER_BLOCK). It
//     forms the composite's gradients of every pixel from the saved sums in
//     shared memory (and g_bg, in the image's first block) with their
//     full-canvas sums of g_S2 and g_S3. Then, a cell at a time: the taps and
//     the band; a thread a band pixel recomputes the paste and the noise
//     once, keeps the paste's gradient in shared memory and its parts of g_ys
//     and g_xs; then, with no atomics and in a fixed order, g_obj is gathered
//     a thread an object pixel over the band's canvas rows and the columns
//     that tap it, g_ys summed a thread a band row (0 outside the band), g_xs
//     a thread a column over the band rows. Two runs give bit-equal results.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (split_vae_torch/kernels/render_windowed.py loads it with ctypes).

#include <cuda_runtime.h>

#include "paste_taps.cuh"

extern "C" {

const char* render_windowed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// objs [B,K,h,w,C+1], ys [B,K,H], xs [B,K,W], zp/wd [B,K], bg/out [B,H,W,C],
// sums [B,C+2,H,W] (S1 planes, S2, S3 with the closed-form terms: written for
// the backward); seed: one int32 in device memory; `rows` canvas rows a block
// (at most 512 threads). Returns the launch's cudaError_t.
int render_windowed_fwd(const float* objs, const float* ys, const float* xs, const float* zp,
                        const float* wd, const float* bg, const int* seed, float noise_scale,
                        float* out, float* sums, int B, int K, int h, int w, int H, int W, int C,
                        int rows, void* stream) {
  return render_fwd_any<true>(objs, ys, xs, zp, wd, bg, seed, noise_scale, out, sums, B, K, h,
                              w, H, W, C, rows, stream);
}

// sums: the forward's; g [B,H,W,C] -> g_objs, g_ys (0 outside each band),
// g_xs, g_zp, g_wd, g_bg shaped as their inputs; `cpb` cells a block.
int render_windowed_bwd(const float* objs, const float* ys, const float* xs, const float* zp,
                        const float* wd, const float* bg, const int* seed, float noise_scale,
                        const float* sums, const float* g, float* g_objs, float* g_ys,
                        float* g_xs, float* g_zp, float* g_wd, float* g_bg, int B, int K, int h,
                        int w, int H, int W, int C, int cpb, void* stream) {
  return render_bwd_any<true>(objs, ys, xs, zp, wd, bg, seed, noise_scale, sums, g, g_objs,
                              g_ys, g_xs, g_zp, g_wd, g_bg, B, K, h, w, H, W, C, cpb, stream);
}

}  // extern "C"
