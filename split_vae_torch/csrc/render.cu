// Fused paste + depth-aware alpha composite for SPAIR, forward and backward.
//
// Replaces the Pallas TPU kernel pair in
// split_vae_tpu/ops/pallas/render_packed.py (_fwd_kernel, _bwd_kernel) and
// its unpacked twin render_fused.py: the port takes any object size h x w and
// canvas size H x W (no multiple-of-8 rule).
//
// Per image b and cell k (layouts as the JAX package's, channel last):
//   paste_c = Wy[b,k] . obj[b,k,:,:,c] . Wx[b,k]^T                 [H, W]
//   alpha   = clip(paste_C, 1e-8, 1)
//   rgb_c   = clip(paste_c + noise_scale * N(0,1), 0, 1)
//   imp     = z_pres * alpha * depth_w
//   S1_c += imp * rgb_c;  S2 += imp;  S3 += z_pres * alpha * imp
//   out_c = (S3/D) * (S1/D) + (1 - S3/D) * bg_c,   D = S2 + 1e-8
//
// Design: one block per image, a loop over the K cells inside the block (the
// TPU grid's sequential axis). Each cell's object, Wy and Wx are staged in
// shared memory; tmp = obj . Wx^T is formed there, and every thread owns a
// 3x3 group of output pixels, strided across the canvas, whose paste it
// finishes in registers and whose three sums it keeps in registers across
// the cells. The noise is Philox-4x32-10 keyed by (seed + b) with the
// element's position as the counter, so the backward regenerates exactly the
// forward's values with no stream state.
//
// The backward does not keep the K pastes (the TPU kernel kept them in VMEM;
// here they would not fit in shared memory): pass 1 recomputes the sums and
// writes the composite's gradients to a scratch buffer, pass 2 recomputes
// each cell's paste and pushes the gradient back through the two small
// matrix products. All arithmetic is plain fp32 FMA.
//
// Shared-memory bank conflicts are the first limit of such small products:
// every shared array has an odd row length, and a thread's rows and columns
// are strided (m = tm + i*MT, see tile_gemm.cuh), so the 32 threads of a warp
// read 32 banks.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (split_vae_torch/kernels/render.py loads it with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "tile_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;
constexpr int PY = 3;  // output rows per thread group
constexpr int PX = 3;  // output columns per thread group

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

struct Shapes {
  int K, h, w, H, W;
};

// Shared-memory layout, in floats. Row lengths are odd (see the header).
struct Layout {
  int ldo, ldy, ldx, ldt, ldb, ldg;  // rows of obj, Wy, Wx, tmp, buf, gp
  int wy, wx, tmp, gp, red, total;   // offsets (obj at 0) and the size
};

__host__ __device__ inline int odd(int n) { return n | 1; }

__host__ __device__ inline Layout make_layout(int C1, const Shapes& s, bool backward) {
  Layout l;
  l.ldo = odd(s.w);
  l.ldy = odd(s.h);
  l.ldx = odd(s.w);
  l.ldt = odd(s.W);
  l.ldb = odd(s.w);
  l.ldg = odd(s.W);
  l.wy = C1 * s.h * l.ldo;
  l.wx = l.wy + s.H * l.ldy;
  l.tmp = l.wx + s.W * l.ldx;
  // The backward reuses tmp's space for buf once tmp is no longer needed.
  const int tmp_size = C1 * s.h * l.ldt, buf_size = C1 * s.H * l.ldb;
  l.gp = l.tmp + (backward && buf_size > tmp_size ? buf_size : tmp_size);
  l.red = l.gp + (backward ? C1 * s.H * l.ldg : 0);
  l.total = l.red + (backward ? 32 : 0);
  return l;
}

// Copies cell (b, k) into shared memory: obj as [C1][h][ldo], Wy [H][ldy], Wx [W][ldx].
template <int C1>
__device__ void stage_cell(const float* __restrict__ objs, const float* __restrict__ wy,
                           const float* __restrict__ wx, int b, int k, const Shapes& s,
                           const Layout& l, float* smem) {
  const int hw = s.h * s.w;
  const size_t cell = (size_t)b * s.K + k;
  const float* o = objs + cell * hw * C1;
  for (int e = threadIdx.x; e < hw * C1; e += blockDim.x) {
    const int c = e % C1, p = e / C1;
    smem[(c * s.h + p / s.w) * l.ldo + p % s.w] = o[e];
  }
  const float* y = wy + cell * s.H * s.h;
  for (int e = threadIdx.x; e < s.H * s.h; e += blockDim.x)
    smem[l.wy + (e / s.h) * l.ldy + e % s.h] = y[e];
  const float* x = wx + cell * s.W * s.w;
  for (int e = threadIdx.x; e < s.W * s.w; e += blockDim.x)
    smem[l.wx + (e / s.w) * l.ldx + e % s.w] = x[e];
}

// tmp[c][i][x] = sum_j obj[c][i][j] * Wx[x][j]   ([C1*h, W], shared memory)
template <int C1>
__device__ void cell_tmp(const Shapes& s, const Layout& l, float* smem) {
  gemm<4, 6>(smem, 0, l.ldo, 1, smem + l.wx, 0, l.ldx, 1, smem + l.tmp, l.ldt, 1, C1 * s.h, s.W,
             s.w);
}

// A thread group: PY x PX pixels at rows yg + py*GY and columns xg + px*GX.
struct Group {
  int yg, xg, GY, GX;
  bool active;
  __device__ Group(int g, const Shapes& s) {
    GY = (s.H + PY - 1) / PY;
    GX = (s.W + PX - 1) / PX;
    active = g < GY * GX;
    yg = g / GX;
    xg = g % GX;
  }
  __device__ int y(int py) const { return yg + py * GY; }
  __device__ int x(int px) const { return xg + px * GX; }
  __device__ bool in(int py, int px, const Shapes& s) const {
    return active && y(py) < s.H && x(px) < s.W;
  }
};

// paste[c][py][px] for the group: sum_i Wy[y][i] * tmp[c][i][x].
template <int C1>
__device__ __forceinline__ void paste_group(const float* smem, const Group& gr, const Shapes& s,
                                            const Layout& l, float acc[C1][PY][PX]) {
#pragma unroll
  for (int c = 0; c < C1; ++c)
#pragma unroll
    for (int py = 0; py < PY; ++py)
#pragma unroll
      for (int px = 0; px < PX; ++px) acc[c][py][px] = 0.f;
  int ys[PY], xs[PX];
#pragma unroll
  for (int py = 0; py < PY; ++py) ys[py] = min(gr.y(py), s.H - 1);
#pragma unroll
  for (int px = 0; px < PX; ++px) xs[px] = min(gr.x(px), s.W - 1);
  const float* s_wy = smem + l.wy;
  const float* s_tmp = smem + l.tmp;
  for (int i = 0; i < s.h; ++i) {
    float a[PY];
#pragma unroll
    for (int py = 0; py < PY; ++py) a[py] = s_wy[ys[py] * l.ldy + i];
#pragma unroll
    for (int c = 0; c < C1; ++c)
#pragma unroll
      for (int px = 0; px < PX; ++px) {
        const float t = s_tmp[(c * s.h + i) * l.ldt + xs[px]];
#pragma unroll
        for (int py = 0; py < PY; ++py) acc[c][py][px] = fmaf(a[py], t, acc[c][py][px]);
      }
  }
}

// S1 (C planes), S2, S3 over all K cells for the group of pixels g, in
// registers. Every thread of the block takes part (staging and syncs), also
// one whose group lies past the canvas.
template <int C1>
__device__ void group_sums(const float* __restrict__ objs, const float* __restrict__ wy,
                           const float* __restrict__ wx, const float* __restrict__ zp,
                           const float* __restrict__ wd, uint32_t key, float noise_scale, int b,
                           const Group& gr, const Shapes& s, const Layout& l, float* smem,
                           float sums[C1 + 1][PY][PX]) {
  constexpr int C = C1 - 1;
  const int HW = s.H * s.W;
#pragma unroll
  for (int c = 0; c < C1 + 1; ++c)
#pragma unroll
    for (int py = 0; py < PY; ++py)
#pragma unroll
      for (int px = 0; px < PX; ++px) sums[c][py][px] = 0.f;
  for (int k = 0; k < s.K; ++k) {
    stage_cell<C1>(objs, wy, wx, b, k, s, l, smem);
    __syncthreads();
    cell_tmp<C1>(s, l, smem);
    __syncthreads();
    const float z = zp[b * s.K + k], dw = wd[b * s.K + k];
    float acc[C1][PY][PX];
    paste_group<C1>(smem, gr, s, l, acc);
#pragma unroll
    for (int py = 0; py < PY; ++py)
#pragma unroll
      for (int px = 0; px < PX; ++px) {
        if (!gr.in(py, px, s)) continue;
        const int p = gr.y(py) * s.W + gr.x(px);
        const float alpha = clip(acc[C][py][px], kEps, 1.f);
        const float transp = z * alpha;
        const float imp = transp * dw;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          float v = acc[c][py][px];
          if (noise_scale > 0.f) v += noise_scale * normal_at(key, (uint32_t)((k * C + c) * HW + p));
          sums[c][py][px] += imp * clip(v, 0.f, 1.f);
        }
        sums[C][py][px] += imp;
        sums[C + 1][py][px] += transp * imp;
      }
    __syncthreads();
  }
}

template <int C1>
__global__ void __launch_bounds__(kThreads, 2)
    render_fwd_kernel(const float* __restrict__ objs, const float* __restrict__ wy,
                      const float* __restrict__ wx, const float* __restrict__ zp,
                      const float* __restrict__ wd, const float* __restrict__ bg,
                      const int* __restrict__ seed, float noise_scale, float* __restrict__ out,
                      Shapes s) {
  constexpr int C = C1 - 1;
  extern __shared__ float smem[];
  const Layout l = make_layout(C1, s, false);
  const int b = blockIdx.x, HW = s.H * s.W;
  const int groups = ((s.H + PY - 1) / PY) * ((s.W + PX - 1) / PX);
  const uint32_t key = (uint32_t)seed[0] + (uint32_t)b;
  // More groups than threads (large canvases): one pass over the cells each.
  for (int g0 = 0; g0 < groups; g0 += blockDim.x) {
    const Group gr(g0 + threadIdx.x, s);
    float sums[C1 + 1][PY][PX];
    group_sums<C1>(objs, wy, wx, zp, wd, key, noise_scale, b, gr, s, l, smem, sums);
#pragma unroll
    for (int py = 0; py < PY; ++py)
#pragma unroll
      for (int px = 0; px < PX; ++px) {
        if (!gr.in(py, px, s)) continue;
        const size_t o = ((size_t)b * HW + gr.y(py) * s.W + gr.x(px)) * C;
        const float d = sums[C][py][px] + kEps;
        const float ac = sums[C + 1][py][px] / d;
#pragma unroll
        for (int c = 0; c < C; ++c)
          out[o + c] = ac * (sums[c][py][px] / d) + (1.f - ac) * bg[o + c];
      }
  }
}

// Sums v over the block; the result is valid in thread 0. Uses red[0..31].
__device__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) {
    t = (lane < (int)(blockDim.x >> 5)) ? red[lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
  }
  __syncthreads();
  return t;
}

template <int C1>
__global__ void __launch_bounds__(kThreads, 2)
    render_bwd_kernel(const float* __restrict__ objs, const float* __restrict__ wy,
                      const float* __restrict__ wx, const float* __restrict__ zp,
                      const float* __restrict__ wd, const float* __restrict__ bg,
                      const int* __restrict__ seed, float noise_scale,
                      const float* __restrict__ gout, float* __restrict__ g_objs,
                      float* __restrict__ g_wy, float* __restrict__ g_wx,
                      float* __restrict__ g_zp, float* __restrict__ g_wd,
                      float* __restrict__ g_bg, float* __restrict__ scratch, Shapes s) {
  constexpr int C = C1 - 1;
  extern __shared__ float smem[];
  const Layout l = make_layout(C1, s, true);
  const int b = blockIdx.x, HW = s.H * s.W;
  const int groups = ((s.H + PY - 1) / PY) * ((s.W + PX - 1) / PX);
  const uint32_t key = (uint32_t)seed[0] + (uint32_t)b;
  // g_S1 (C planes), g_S2, g_S3 of this image: written and read back by the
  // thread that owns each pixel.
  float* gs = scratch + (size_t)b * (C + 2) * HW;

  // Pass 1: the three sums, then the gradients of the composite.
  for (int g0 = 0; g0 < groups; g0 += blockDim.x) {
    const Group gr(g0 + threadIdx.x, s);
    float sums[C1 + 1][PY][PX];
    group_sums<C1>(objs, wy, wx, zp, wd, key, noise_scale, b, gr, s, l, smem, sums);
#pragma unroll
    for (int py = 0; py < PY; ++py)
#pragma unroll
      for (int px = 0; px < PX; ++px) {
        if (!gr.in(py, px, s)) continue;
        const int p = gr.y(py) * s.W + gr.x(px);
        const float s2 = sums[C][py][px], s3 = sums[C + 1][py][px];
        const float inv_d = 1.f / (s2 + kEps), inv_d2 = inv_d * inv_d;
        const size_t o = ((size_t)b * HW + p) * C;
        float gs2 = 0.f, gs3 = 0.f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float g = gout[o + c], s1 = sums[c][py][px], bgv = bg[o + c];
          gs3 += g * (s1 * inv_d2 - bgv * inv_d);
          gs2 += g * (-2.f * s1 * (s3 * inv_d2 * inv_d) + bgv * (s3 * inv_d2));
          g_bg[o + c] = g * (1.f - s3 * inv_d);
          gs[c * HW + p] = g * (s3 * inv_d2);
        }
        gs[C * HW + p] = gs2;
        gs[(C + 1) * HW + p] = gs3;
      }
  }

  // Pass 2: per cell, recompute the paste and push the gradient through it.
  float* s_obj = smem;
  const float* s_wy = smem + l.wy;
  const float* s_wx = smem + l.wx;
  float* s_tmp = smem + l.tmp;
  float* s_buf = smem + l.tmp;  // shares tmp's space: written once tmp is used up
  float* s_gp = smem + l.gp;    // [C1][H][ldg]: gradient of the paste
  const int tplane = s.h * l.ldt, bplane = s.H * l.ldb, gplane = s.H * l.ldg;
  for (int k = 0; k < s.K; ++k) {
    stage_cell<C1>(objs, wy, wx, b, k, s, l, smem);
    __syncthreads();
    cell_tmp<C1>(s, l, smem);
    __syncthreads();
    const float z = zp[b * s.K + k], dw = wd[b * s.K + k];
    float part_zp = 0.f, part_wd = 0.f;
    for (int g0 = 0; g0 < groups; g0 += blockDim.x) {
      const Group gr(g0 + threadIdx.x, s);
      float acc[C1][PY][PX];
      paste_group<C1>(smem, gr, s, l, acc);
#pragma unroll
      for (int py = 0; py < PY; ++py)
#pragma unroll
        for (int px = 0; px < PX; ++px) {
          if (!gr.in(py, px, s)) continue;
          const int y = gr.y(py), x = gr.x(px), p = y * s.W + x;
          const float alpha_raw = acc[C][py][px];
          const float alpha = clip(alpha_raw, kEps, 1.f);
          const float transp = z * alpha;
          const float imp = transp * dw;
          const float gs2 = gs[C * HW + p], gs3 = gs[(C + 1) * HW + p];
          float g_imp = gs2 + gs3 * transp;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float v = acc[c][py][px];
            if (noise_scale > 0.f) v += noise_scale * normal_at(key, (uint32_t)((k * C + c) * HW + p));
            const float rgb = clip(v, 0.f, 1.f);
            const float gs1 = gs[c * HW + p];
            g_imp += gs1 * rgb;
            s_gp[c * gplane + y * l.ldg + x] = (rgb > 0.f && rgb < 1.f) ? gs1 * imp : 0.f;
          }
          const float g_transp = gs3 * imp;
          const bool alpha_in = alpha_raw > kEps && alpha_raw < 1.f;
          s_gp[C * gplane + y * l.ldg + x] = alpha_in ? (g_imp * (z * dw) + g_transp * z) : 0.f;
          part_zp += g_imp * alpha * dw + g_transp * alpha;
          part_wd += g_imp * z * alpha;
        }
    }
    const float sum_zp = block_sum(part_zp, smem + l.red);
    const float sum_wd = block_sum(part_wd, smem + l.red);
    if (threadIdx.x == 0) {
      g_zp[b * s.K + k] = sum_zp;
      g_wd[b * s.K + k] = sum_wd;
    }
    // block_sum ends in __syncthreads(), so s_gp is complete here.
    const size_t cell = (size_t)b * s.K + k;
    float* gobj = g_objs + cell * s.h * s.w * C1;
    // g_wy[y][i] = sum_c sum_x gp[c][y][x] * tmp[c][i][x]
    gemm<3, 2>(s_gp, gplane, l.ldg, 1, s_tmp, tplane, l.ldt, 1, g_wy + cell * s.H * s.h, s.h, 1,
               s.H, s.h, s.W, C1);
    __syncthreads();
    // buf[c][y][j] = sum_x gp[c][y][x] * Wx[x][j]   (over tmp's space)
    gemm<6, 4>(s_gp, 0, l.ldg, 1, s_wx, 0, 1, l.ldx, s_buf, l.ldb, 1, C1 * s.H, s.w, s.W);
    __syncthreads();
    // g_obj[i][j][c] = sum_y Wy[y][i] * buf[c][y][j]
    for (int c = 0; c < C1; ++c)
      gemm<2, 2>(s_wy, 0, 1, l.ldy, s_buf + c * bplane, 0, 1, l.ldb, gobj + c, s.w * C1, C1,
                 s.h, s.w, s.H);
    __syncthreads();
    // buf[c][y][j] = sum_i Wy[y][i] * obj[c][i][j]
    for (int c = 0; c < C1; ++c)
      gemm<3, 2>(s_wy, 0, l.ldy, 1, s_obj + c * s.h * l.ldo, 0, 1, l.ldo, s_buf + c * bplane,
                 l.ldb, 1, s.H, s.w, s.h);
    __syncthreads();
    // g_wx[x][j] = sum_c sum_y gp[c][y][x] * buf[c][y][j]
    gemm<3, 2>(s_gp, gplane, 1, l.ldg, s_buf, bplane, 1, l.ldb, g_wx + cell * s.W * s.w, s.w, 1,
               s.W, s.w, s.H, C1);
    __syncthreads();
  }
}

__global__ void render_noise_kernel(const int* __restrict__ seed, float* __restrict__ out,
                                    int per_image, long long total) {
  const long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int b = (int)(e / per_image), pos = (int)(e % per_image);
  out[e] = normal_at((uint32_t)seed[0] + (uint32_t)b, (uint32_t)pos);
}

template <int C1>
cudaError_t launch_fwd(const float* objs, const float* wy, const float* wx, const float* zp,
                       const float* wd, const float* bg, const int* seed, float noise_scale,
                       float* out, int B, const Shapes& s, cudaStream_t stream) {
  const size_t smem = sizeof(float) * make_layout(C1, s, false).total;
  cudaError_t err = cudaFuncSetAttribute(render_fwd_kernel<C1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  render_fwd_kernel<C1><<<B, kThreads, smem, stream>>>(objs, wy, wx, zp, wd, bg, seed,
                                                        noise_scale, out, s);
  return cudaGetLastError();
}

template <int C1>
cudaError_t launch_bwd(const float* objs, const float* wy, const float* wx, const float* zp,
                       const float* wd, const float* bg, const int* seed, float noise_scale,
                       const float* g, float* g_objs, float* g_wy, float* g_wx, float* g_zp,
                       float* g_wd, float* g_bg, float* scratch, int B, const Shapes& s,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * make_layout(C1, s, true).total;
  cudaError_t err = cudaFuncSetAttribute(render_bwd_kernel<C1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  render_bwd_kernel<C1><<<B, kThreads, smem, stream>>>(objs, wy, wx, zp, wd, bg, seed,
                                                        noise_scale, g, g_objs, g_wy, g_wx,
                                                        g_zp, g_wd, g_bg, scratch, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* render_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// objs [B,K,h,w,C+1], wy [B,K,H,h], wx [B,K,W,w], zp/wd [B,K], bg/out [B,H,W,C];
// seed: one int32 in device memory. Returns the launch's cudaError_t.
int render_fwd(const float* objs, const float* wy, const float* wx, const float* zp,
               const float* wd, const float* bg, const int* seed, float noise_scale, float* out,
               int B, int K, int h, int w, int H, int W, int C, void* stream) {
  const Shapes s{K, h, w, H, W};
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1: return launch_fwd<2>(objs, wy, wx, zp, wd, bg, seed, noise_scale, out, B, s, st);
    case 3: return launch_fwd<4>(objs, wy, wx, zp, wd, bg, seed, noise_scale, out, B, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// g [B,H,W,C] -> g_objs, g_wy, g_wx, g_zp, g_wd, g_bg shaped as their inputs;
// scratch: B*(C+2)*H*W floats of working space.
int render_bwd(const float* objs, const float* wy, const float* wx, const float* zp,
               const float* wd, const float* bg, const int* seed, float noise_scale,
               const float* g, float* g_objs, float* g_wy, float* g_wx, float* g_zp, float* g_wd,
               float* g_bg, float* scratch, int B, int K, int h, int w, int H, int W, int C,
               void* stream) {
  const Shapes s{K, h, w, H, W};
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return launch_bwd<2>(objs, wy, wx, zp, wd, bg, seed, noise_scale, g, g_objs, g_wy, g_wx,
                           g_zp, g_wd, g_bg, scratch, B, s, st);
    case 3:
      return launch_bwd<4>(objs, wy, wx, zp, wd, bg, seed, noise_scale, g, g_objs, g_wy, g_wx,
                           g_zp, g_wd, g_bg, scratch, B, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
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
