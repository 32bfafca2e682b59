// Row-windowed fused paste + depth-aware alpha composite, forward and backward.
//
// Replaces the Pallas TPU kernel pair in tools/pallas_research/render_windowed.py
// (_fwd_kernel, _bwd_kernel). The function is render.cu's, with every per-cell
// term confined to the cell's row band [start, start + len) of the canvas and
// the rows outside it, where the paste is exactly zero and so
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
// What the TPU could not do and this kernel does: the band is as long as the
// cell's support (bands[b,k] = (start, len), any len from 0 to H, computed by
// kernels/render_windowed.py), not a fixed 40 of 48 rows aligned to 8, because
// a block indexes shared memory by a run-time row. And because only band rows
// of Wy are non-zero, the products are reordered so that every one of them
// shrinks with the band: u = Wy[band] . obj first (len x w per channel), then
// paste = u . Wx^T, and in the backward g_u = g_paste . Wx, g_obj = Wy^T . g_u,
// g_Wy = g_u . obj^T and g_Wx = g_paste^T . u: six products of len rows where
// render.cu does seven of H rows. The shared-memory tiles are sized for the
// longest possible band (H rows) and the rest is masked.
//
// Design: one block per image, a loop over the K cells in order (the TPU
// grid's sequential axis), so the sums of two cells whose bands overlap are
// added in a fixed order with no atomics. The three sums live in shared
// memory, indexed by the absolute canvas row; each band pixel of a cell is
// owned by one thread. The noise is render.cu's Philox field (philox.cuh)
// with the absolute position ((k*C + c)*H + y)*W + x as counter, so the two
// kernels see the same noise wherever it matters. The backward recomputes:
// pass 1 rebuilds the sums and leaves the composite's gradients in a scratch
// buffer (their space in shared memory is then reused for g_paste), pass 2
// walks the cells again. g_Wy is written in full: zeros outside the band.
//
// Bound (LG-SPAIR config #5, B=256, K=16, 32-px objects, 48-px canvases, fp32,
// H100 SXM): the bytes are render.cu's less the rows of Wy outside the bands
// (~0.034 ms forward, ~0.071 ms backward); the operations scale with the band
// length (20 KFLOP a band row forward, 61 KFLOP backward), so bytes bound the
// forward for bands up to 27 rows and the backward up to a mean of 19 rows.
// PERF.md has the measured times; plain fp32 FMAs from shared memory, no
// tensor cores.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (split_vae_torch/kernels/render_windowed.py loads it with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"
#include "tile_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-8f;
constexpr int PY = 2;  // band rows per thread group
constexpr int PX = 3;  // canvas columns per thread group

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

struct Shapes {
  int K, h, w, H, W;
};

// Shared-memory layout, in floats. Row lengths are odd, so that threads on
// neighbouring rows read different banks.
struct Layout {
  int ldo, ldy, ldx, ldu, ldg;          // rows of obj, Wy, Wx, u, g_paste
  int wy, wx, u, sums, red, total;      // offsets (obj at 0) and the size
};

__host__ __device__ inline int odd(int n) { return n | 1; }

__host__ __device__ inline Layout make_layout(int C1, const Shapes& s, bool backward) {
  Layout l;
  l.ldo = odd(s.w);
  l.ldy = odd(s.h);
  l.ldx = odd(s.w);
  l.ldu = odd(s.w);
  l.ldg = odd(s.W);
  l.wy = C1 * s.h * l.ldo;
  l.wx = l.wy + s.H * l.ldy;
  l.u = l.wx + s.W * l.ldx;
  l.sums = l.u + C1 * s.H * l.ldu;
  // The backward's g_paste [C1][H][ldg] takes the sums' space after pass 1.
  const int sums_size = (C1 + 1) * s.H * s.W, gp_size = C1 * s.H * l.ldg;
  l.red = l.sums + (backward && gp_size > sums_size ? gp_size : sums_size);
  l.total = l.red + (backward ? 4 * 32 : 0);
  return l;
}

// Copies cell (b, k) into shared memory: obj as [C1][h][ldo], the band's rows
// of Wy as [len][ldy] (row r is canvas row start + r), Wx as [W][ldx].
template <int C1>
__device__ void stage_cell(const float* __restrict__ objs, const float* __restrict__ wy,
                           const float* __restrict__ wx, int b, int k, int start, int len,
                           const Shapes& s, const Layout& l, float* smem) {
  const int hw = s.h * s.w;
  const size_t cell = (size_t)b * s.K + k;
  const float* o = objs + cell * hw * C1;
  for (int e = threadIdx.x; e < hw * C1; e += blockDim.x) {
    const int c = e % C1, p = e / C1;
    smem[(c * s.h + p / s.w) * l.ldo + p % s.w] = o[e];
  }
  const float* y = wy + (cell * s.H + start) * s.h;
  for (int e = threadIdx.x; e < len * s.h; e += blockDim.x)
    smem[l.wy + (e / s.h) * l.ldy + e % s.h] = y[e];
  const float* x = wx + cell * s.W * s.w;
  for (int e = threadIdx.x; e < s.W * s.w; e += blockDim.x)
    smem[l.wx + (e / s.w) * l.ldx + e % s.w] = x[e];
}

// u[c][r][j] = sum_i Wy[start + r][i] * obj[c][i][j]   ([C1][len][ldu], shared memory)
template <int C1>
__device__ void cell_u(int len, const Shapes& s, const Layout& l, float* smem) {
  gemm_batch<2, 4>(smem + l.wy, 0, l.ldy, 1, smem, s.h * l.ldo, 1, l.ldo, smem + l.u,
                   s.H * l.ldu, l.ldu, 1, len, s.w, s.h, C1);
}

// A thread group inside a band of len rows: PY x PX pixels at band rows
// rg + py*GY and canvas columns xg + px*GX.
struct Group {
  int rg, xg, GY, GX, len;
  bool active;
  __device__ Group(int g, int len_, const Shapes& s) : len(len_) {
    GY = (len + PY - 1) / PY;
    GX = (s.W + PX - 1) / PX;
    active = g < GY * GX;
    rg = g / GX;
    xg = g % GX;
  }
  __device__ int r(int py) const { return rg + py * GY; }
  __device__ int x(int px) const { return xg + px * GX; }
  __device__ bool in(int py, int px, const Shapes& s) const {
    return active && r(py) < len && x(px) < s.W;
  }
};

__device__ inline int group_count(int len, const Shapes& s) {
  return ((len + PY - 1) / PY) * ((s.W + PX - 1) / PX);
}

// paste[c][py][px] for the group: sum_j u[c][r][j] * Wx[x][j].
template <int C1>
__device__ __forceinline__ void paste_group(const float* smem, const Group& gr, const Shapes& s,
                                            const Layout& l, float acc[C1][PY][PX]) {
#pragma unroll
  for (int c = 0; c < C1; ++c)
#pragma unroll
    for (int py = 0; py < PY; ++py)
#pragma unroll
      for (int px = 0; px < PX; ++px) acc[c][py][px] = 0.f;
  int rs[PY], xs[PX];
#pragma unroll
  for (int py = 0; py < PY; ++py) rs[py] = min(gr.r(py), gr.len - 1);
#pragma unroll
  for (int px = 0; px < PX; ++px) xs[px] = min(gr.x(px), s.W - 1);
  const float* s_wx = smem + l.wx;
  const float* s_u = smem + l.u;
  for (int j = 0; j < s.w; ++j) {
    float a[PX];
#pragma unroll
    for (int px = 0; px < PX; ++px) a[px] = s_wx[xs[px] * l.ldx + j];
#pragma unroll
    for (int c = 0; c < C1; ++c)
#pragma unroll
      for (int py = 0; py < PY; ++py) {
        const float t = s_u[(c * s.H + rs[py]) * l.ldu + j];
#pragma unroll
        for (int px = 0; px < PX; ++px) acc[c][py][px] = fmaf(t, a[px], acc[c][py][px]);
      }
  }
}

// The in-band sums S1 (C planes), S2, S3 of image b over all K cells, in
// shared memory at smem + l.sums as [C+2][H*W]; c_sums gets the two
// closed-form constants sum_k z*wd*1e-8 and sum_k z^2*wd*1e-16, which the
// caller adds to every pixel of S2 and S3. Ends with the sums complete.
template <int C1>
__device__ void band_sums(const float* __restrict__ objs, const float* __restrict__ wy,
                          const float* __restrict__ wx, const float* __restrict__ zp,
                          const float* __restrict__ wd, const int* __restrict__ bands,
                          uint32_t key, float noise_scale, int b, const Shapes& s,
                          const Layout& l, float* smem, float c_sums[2]) {
  constexpr int C = C1 - 1;
  const int HW = s.H * s.W;
  float* s_sum = smem + l.sums;
  for (int e = threadIdx.x; e < (C + 2) * HW; e += blockDim.x) s_sum[e] = 0.f;
  c_sums[0] = c_sums[1] = 0.f;
  for (int k = 0; k < s.K; ++k) {
    const int cell = b * s.K + k;
    const int start = bands[2 * cell], len = bands[2 * cell + 1];
    const float z = zp[cell], dw = wd[cell];
    const float c2 = z * dw * kEps, c3 = z * z * dw * (kEps * kEps);
    c_sums[0] += c2;
    c_sums[1] += c3;
    if (len == 0) continue;  // the same for every thread of the block
    stage_cell<C1>(objs, wy, wx, b, k, start, len, s, l, smem);
    __syncthreads();  // also orders the zeroing above before the first update
    cell_u<C1>(len, s, l, smem);
    __syncthreads();
    const int groups = group_count(len, s);
    for (int g0 = 0; g0 < groups; g0 += blockDim.x) {
      const Group gr(g0 + threadIdx.x, len, s);
      if (!gr.active) continue;
      float acc[C1][PY][PX];
      paste_group<C1>(smem, gr, s, l, acc);
#pragma unroll
      for (int py = 0; py < PY; ++py)
#pragma unroll
        for (int px = 0; px < PX; ++px) {
          if (!gr.in(py, px, s)) continue;
          const int p = (start + gr.r(py)) * s.W + gr.x(px);
          const float alpha = clip(acc[C][py][px], kEps, 1.f);
          const float transp = z * alpha;
          const float imp = transp * dw;
#pragma unroll
          for (int c = 0; c < C; ++c) {
            float v = acc[c][py][px];
            if (noise_scale > 0.f) v += noise_scale * normal_at(key, (uint32_t)((k * C + c) * HW + p));
            s_sum[c * HW + p] += imp * clip(v, 0.f, 1.f);
          }
          s_sum[C * HW + p] += imp - c2;
          s_sum[(C + 1) * HW + p] += transp * imp - c3;
        }
    }
    __syncthreads();
  }
  __syncthreads();  // for an image whose bands are all empty
}

template <int C1>
__global__ void __launch_bounds__(kThreads, 2)
    render_windowed_fwd_kernel(const float* __restrict__ objs, const float* __restrict__ wy,
                               const float* __restrict__ wx, const float* __restrict__ zp,
                               const float* __restrict__ wd, const float* __restrict__ bg,
                               const int* __restrict__ bands, const int* __restrict__ seed,
                               float noise_scale, float* __restrict__ out, Shapes s) {
  constexpr int C = C1 - 1;
  extern __shared__ float smem[];
  const Layout l = make_layout(C1, s, false);
  const int b = blockIdx.x, HW = s.H * s.W;
  const uint32_t key = (uint32_t)seed[0] + (uint32_t)b;
  float c_sums[2];
  band_sums<C1>(objs, wy, wx, zp, wd, bands, key, noise_scale, b, s, l, smem, c_sums);
  const float* s_sum = smem + l.sums;
  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    const float s2 = s_sum[C * HW + p] + c_sums[0], s3 = s_sum[(C + 1) * HW + p] + c_sums[1];
    const float d = s2 + kEps;
    const float ac = s3 / d;
    const size_t o = ((size_t)b * HW + p) * C;
#pragma unroll
    for (int c = 0; c < C; ++c) out[o + c] = ac * (s_sum[c * HW + p] / d) + (1.f - ac) * bg[o + c];
  }
}

// Sums each of v[0..N) over the block and leaves the totals in v on every
// thread (all threads add the warps' partial sums in the same order). Uses
// red[0 .. 32*N).
template <int N>
__device__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[n] += __shfl_xor_sync(0xffffffffu, v[n], o);
    if (lane == 0) red[warp * N + n] = v[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float t = 0.f;
    for (int w = 0; w < warps; ++w) t += red[w * N + n];
    v[n] = t;
  }
  __syncthreads();
}

template <int C1>
__global__ void __launch_bounds__(kThreads, 2)
    render_windowed_bwd_kernel(const float* __restrict__ objs, const float* __restrict__ wy,
                               const float* __restrict__ wx, const float* __restrict__ zp,
                               const float* __restrict__ wd, const float* __restrict__ bg,
                               const int* __restrict__ bands, const int* __restrict__ seed,
                               float noise_scale, const float* __restrict__ gout,
                               float* __restrict__ g_objs, float* __restrict__ g_wy,
                               float* __restrict__ g_wx, float* __restrict__ g_zp,
                               float* __restrict__ g_wd, float* __restrict__ g_bg,
                               float* __restrict__ scratch, Shapes s) {
  constexpr int C = C1 - 1;
  extern __shared__ float smem[];
  const Layout l = make_layout(C1, s, true);
  const int b = blockIdx.x, HW = s.H * s.W;
  const uint32_t key = (uint32_t)seed[0] + (uint32_t)b;
  float* red = smem + l.red;
  // g_S1 (C planes), g_S2, g_S3 of this image, passed from pass 1 to pass 2.
  float* gs = scratch + (size_t)b * (C + 2) * HW;

  // Pass 1: the three sums, then the gradients of the composite on the full
  // canvas and the full-canvas sums of g_S2 and g_S3.
  float c_sums[2];
  band_sums<C1>(objs, wy, wx, zp, wd, bands, key, noise_scale, b, s, l, smem, c_sums);
  float full[2] = {0.f, 0.f};
  {
    const float* s_sum = smem + l.sums;
    for (int p = threadIdx.x; p < HW; p += blockDim.x) {
      const float s2 = s_sum[C * HW + p] + c_sums[0], s3 = s_sum[(C + 1) * HW + p] + c_sums[1];
      const float inv_d = 1.f / (s2 + kEps), inv_d2 = inv_d * inv_d;
      const size_t o = ((size_t)b * HW + p) * C;
      float gs2 = 0.f, gs3 = 0.f;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const float g = gout[o + c], s1 = s_sum[c * HW + p], bgv = bg[o + c];
        gs3 += g * (s1 * inv_d2 - bgv * inv_d);
        gs2 += g * (-2.f * s1 * (s3 * inv_d2 * inv_d) + bgv * (s3 * inv_d2));
        g_bg[o + c] = g * (1.f - s3 * inv_d);
        gs[c * HW + p] = g * (s3 * inv_d2);
      }
      gs[C * HW + p] = gs2;
      gs[(C + 1) * HW + p] = gs3;
      full[0] += gs2;
      full[1] += gs3;
    }
  }
  // Ends in __syncthreads(): the scratch writes above are visible to the
  // block, and the sums' shared memory is free for g_paste.
  block_sum<2>(full, red);

  // Pass 2: per cell, recompute the band's paste and push the gradient back
  // through the two products.
  float* s_obj = smem;
  const float* s_wy = smem + l.wy;
  const float* s_wx = smem + l.wx;
  float* s_u = smem + l.u;
  float* s_gp = smem + l.sums;  // [C1][H][ldg], band rows only
  const int oplane = s.h * l.ldo, uplane = s.H * l.ldu, gplane = s.H * l.ldg;
  for (int k = 0; k < s.K; ++k) {
    const size_t cell = (size_t)b * s.K + k;
    const int start = bands[2 * cell], len = bands[2 * cell + 1];
    const float z = zp[cell], dw = wd[cell];
    float* gobj = g_objs + cell * s.h * s.w * C1;
    float* gwy = g_wy + cell * s.H * s.h;
    float* gwx = g_wx + cell * s.W * s.w;
    // Rows of g_Wy outside the band are zero: Wy is zero there and nothing
    // of the cell was computed from them.
    for (int e = threadIdx.x; e < s.H * s.h; e += blockDim.x) {
      const int y = e / s.h;
      if (y < start || y >= start + len) gwy[e] = 0.f;
    }
    float part[4] = {0.f, 0.f, 0.f, 0.f};  // for g_zp, g_wd; in-band sums of g_S2, g_S3
    if (len > 0) {
      stage_cell<C1>(objs, wy, wx, b, k, start, len, s, l, smem);
      __syncthreads();
      cell_u<C1>(len, s, l, smem);
      __syncthreads();
      const int groups = group_count(len, s);
      for (int g0 = 0; g0 < groups; g0 += blockDim.x) {
        const Group gr(g0 + threadIdx.x, len, s);
        if (!gr.active) continue;
        float acc[C1][PY][PX];
        paste_group<C1>(smem, gr, s, l, acc);
#pragma unroll
        for (int py = 0; py < PY; ++py)
#pragma unroll
          for (int px = 0; px < PX; ++px) {
            if (!gr.in(py, px, s)) continue;
            const int r = gr.r(py), x = gr.x(px), p = (start + r) * s.W + x;
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
              s_gp[c * gplane + r * l.ldg + x] = (rgb > 0.f && rgb < 1.f) ? gs1 * imp : 0.f;
            }
            const float g_transp = gs3 * imp;
            const bool alpha_in = alpha_raw > kEps && alpha_raw < 1.f;
            s_gp[C * gplane + r * l.ldg + x] = alpha_in ? (g_imp * (z * dw) + g_transp * z) : 0.f;
            part[0] += g_imp * alpha * dw + g_transp * alpha;
            part[1] += g_imp * z * alpha;
            part[2] += gs2;
            part[3] += gs3;
          }
      }
    }
    block_sum<4>(part, red);  // ends in __syncthreads(): s_gp is complete
    if (threadIdx.x == 0) {
      // The band's exact terms plus the 1e-8-scale terms of the rows outside
      // it, where alpha is 1e-8 (1e-16 cross terms dropped).
      const float out_gs2 = full[0] - part[2], out_gs3 = full[1] - part[3];
      g_zp[cell] = part[0] + kEps * (dw * out_gs2 + 2.f * z * dw * kEps * out_gs3);
      g_wd[cell] = part[1] + kEps * z * out_gs2 + (kEps * kEps) * z * z * out_gs3;
    }
    if (len == 0) {  // nothing of the cell reaches the canvas
      for (int e = threadIdx.x; e < s.h * s.w * C1; e += blockDim.x) gobj[e] = 0.f;
      for (int e = threadIdx.x; e < s.W * s.w; e += blockDim.x) gwx[e] = 0.f;
      continue;
    }
    // g_wx[x][j] = sum_c sum_r gp[c][r][x] * u[c][r][j]
    gemm<3, 2>(s_gp, gplane, 1, l.ldg, s_u, uplane, 1, l.ldu, gwx, s.w, 1, s.W, s.w, len, C1);
    __syncthreads();
    // g_u[c][r][j] = sum_x gp[c][r][x] * Wx[x][j]   (over u's space)
    gemm_batch<2, 4>(s_gp, gplane, l.ldg, 1, s_wx, 0, 1, l.ldx, s_u, uplane, l.ldu, 1, len, s.w,
                     s.W, C1);
    __syncthreads();
    // g_obj[i][j][c] = sum_r Wy[start + r][i] * g_u[c][r][j]
    gemm_batch<2, 4>(s_wy, 0, 1, l.ldy, s_u, uplane, 1, l.ldu, gobj, 1, s.w * C1, C1, s.h, s.w,
                     len, C1);
    // g_wy[start + r][i] = sum_c sum_j g_u[c][r][j] * obj[c][i][j]
    gemm<2, 2>(s_u, uplane, l.ldu, 1, s_obj, oplane, l.ldo, 1, gwy + start * s.h, s.h, 1, len,
               s.h, s.w, C1);
    __syncthreads();
  }
}

template <int C1>
cudaError_t launch_fwd(const float* objs, const float* wy, const float* wx, const float* zp,
                       const float* wd, const float* bg, const int* bands, const int* seed,
                       float noise_scale, float* out, int B, const Shapes& s,
                       cudaStream_t stream) {
  const size_t smem = sizeof(float) * make_layout(C1, s, false).total;
  cudaError_t err = cudaFuncSetAttribute(render_windowed_fwd_kernel<C1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  render_windowed_fwd_kernel<C1><<<B, kThreads, smem, stream>>>(objs, wy, wx, zp, wd, bg, bands,
                                                                 seed, noise_scale, out, s);
  return cudaGetLastError();
}

template <int C1>
cudaError_t launch_bwd(const float* objs, const float* wy, const float* wx, const float* zp,
                       const float* wd, const float* bg, const int* bands, const int* seed,
                       float noise_scale, const float* g, float* g_objs, float* g_wy, float* g_wx,
                       float* g_zp, float* g_wd, float* g_bg, float* scratch, int B,
                       const Shapes& s, cudaStream_t stream) {
  const size_t smem = sizeof(float) * make_layout(C1, s, true).total;
  cudaError_t err = cudaFuncSetAttribute(render_windowed_bwd_kernel<C1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  render_windowed_bwd_kernel<C1><<<B, kThreads, smem, stream>>>(
      objs, wy, wx, zp, wd, bg, bands, seed, noise_scale, g, g_objs, g_wy, g_wx, g_zp, g_wd, g_bg,
      scratch, s);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* render_windowed_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// objs [B,K,h,w,C+1], wy [B,K,H,h], wx [B,K,W,w], zp/wd [B,K], bg/out [B,H,W,C],
// bands [B,K,2] int32 (start row, number of rows; start + rows <= H);
// seed: one int32 in device memory. Returns the launch's cudaError_t.
int render_windowed_fwd(const float* objs, const float* wy, const float* wx, const float* zp,
                        const float* wd, const float* bg, const int* bands, const int* seed,
                        float noise_scale, float* out, int B, int K, int h, int w, int H, int W,
                        int C, void* stream) {
  const Shapes s{K, h, w, H, W};
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return launch_fwd<2>(objs, wy, wx, zp, wd, bg, bands, seed, noise_scale, out, B, s, st);
    case 3:
      return launch_fwd<4>(objs, wy, wx, zp, wd, bg, bands, seed, noise_scale, out, B, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// g [B,H,W,C] -> g_objs, g_wy, g_wx, g_zp, g_wd, g_bg shaped as their inputs
// (g_wy zero outside each band); scratch: B*(C+2)*H*W floats of working space.
int render_windowed_bwd(const float* objs, const float* wy, const float* wx, const float* zp,
                        const float* wd, const float* bg, const int* bands, const int* seed,
                        float noise_scale, const float* g, float* g_objs, float* g_wy,
                        float* g_wx, float* g_zp, float* g_wd, float* g_bg, float* scratch, int B,
                        int K, int h, int w, int H, int W, int C, void* stream) {
  const Shapes s{K, h, w, H, W};
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return launch_bwd<2>(objs, wy, wx, zp, wd, bg, bands, seed, noise_scale, g, g_objs, g_wy,
                           g_wx, g_zp, g_wd, g_bg, scratch, B, s, st);
    case 3:
      return launch_bwd<4>(objs, wy, wx, zp, wd, bg, bands, seed, noise_scale, g, g_objs, g_wy,
                           g_wx, g_zp, g_wd, g_bg, scratch, B, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
