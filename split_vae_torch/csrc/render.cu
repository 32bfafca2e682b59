// Fused paste + depth-aware alpha composite for SPAIR as a four-tap paste
// from the sample coordinates, forward and backward.
//
// Replaces the Pallas TPU kernel pair in
// split_vae_tpu/ops/pallas/render_packed.py (_fwd_kernel, _bwd_kernel) and
// its unpacked twin render_fused.py. Those take dense interpolation matrices
// wy [B,K,H,h] and wx [B,K,W,w] and multiply them out on the MXU. Every row of
// wy and wx holds at most two non-zeros, so this pair takes the paste's sample
// coordinates ys [B,K,H] and xs [B,K,W] (in object pixels) instead and reads
// four taps a canvas pixel: one pair for any h, w, H, W and K, C = 1 or 3.
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
// clock on 132 SMs x 128 lanes at 1.98 GHz, against ~95 MB (forward) and
// ~170 MB (backward) of bytes, 28 and 51 us at 3.35 TB/s, and 0.25 / 0.39
// GFLOP of arithmetic, 4 and 6 us. The render_noise kernel alone, which
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
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (split_vae_torch/kernels/render.py loads it with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr float kEps = 1e-8f;
constexpr int kFwdMaxThreads = 512;
constexpr int kBwdThreads = 256;

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

struct Shapes {
  int K, h, w, H, W;
};

// The two taps of a coordinate: object indices and their weights. Where the
// clamped indices coincide (in() is false) both weights are 0.
struct __align__(16) Tap {
  int i0, i1;
  float w0, w1;
  __device__ bool in() const { return i0 != i1; }
};

// interp_matrix's taps of u on an axis of n object pixels: floor and clamp in
// fp32, so a huge coordinate never reaches an int conversion.
__device__ __forceinline__ Tap make_tap(float u, int n) {
  const float hi = (float)(n - 1);
  const float x0 = floorf(u);
  const float i0 = fminf(fmaxf(x0, 0.f), hi);
  const float i1 = fminf(fmaxf(x0 + 1.f, 0.f), hi);
  const bool apart = i0 != i1;
  Tap t;
  t.i0 = (int)i0;
  t.i1 = (int)i1;
  t.w0 = apart ? i1 - u : 0.f;
  t.w1 = apart ? u - i0 : 0.f;
  return t;
}

// One pixel of C1 floats: one 16-byte (C1 = 4) or 8-byte (C1 = 2) access.
template <int C1>
struct Px;

template <>
struct Px<4> {
  static __device__ __forceinline__ void load(const float* p, float v[4]) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
  static __device__ __forceinline__ void get(const float* p, float v[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  }
  static __device__ __forceinline__ void put(float* p, const float v[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  }
};

template <>
struct Px<2> {
  static __device__ __forceinline__ void load(const float* p, float v[2]) {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x, v[1] = t.y;
  }
  static __device__ __forceinline__ void get(const float* p, float v[2]) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  }
  static __device__ __forceinline__ void put(float* p, const float v[2]) {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
};

// The four taps of a canvas pixel whose row and column taps both lie in the
// object: a = obj[i0][j0], b = obj[i0][j1], c = obj[i1][j0], d = obj[i1][j1].
template <int C1>
struct Quad {
  float a[C1], b[C1], c[C1], d[C1];
};

template <int C1>
__device__ __forceinline__ void load_quad(const float* __restrict__ obj, const Tap& ty,
                                          const Tap& tx, int w, Quad<C1>& q) {
  Px<C1>::load(obj + (ty.i0 * w + tx.i0) * C1, q.a);
  Px<C1>::load(obj + (ty.i0 * w + tx.i1) * C1, q.b);
  Px<C1>::load(obj + (ty.i1 * w + tx.i0) * C1, q.c);
  Px<C1>::load(obj + (ty.i1 * w + tx.i1) * C1, q.d);
}

// The paste with the dense products' roundings: rows first, the i0 product
// and an FMA of the i1 one onto it, then columns the same way.
template <int C1>
__device__ __forceinline__ void paste_quad(const Quad<C1>& q, const Tap& ty, const Tap& tx,
                                           float v[C1]) {
#pragma unroll
  for (int c = 0; c < C1; ++c) {
    const float left = fmaf(ty.w1, q.c[c], ty.w0 * q.a[c]);
    const float right = fmaf(ty.w1, q.d[c], ty.w0 * q.b[c]);
    v[c] = fmaf(tx.w1, right, tx.w0 * left);
  }
}

// A thread a canvas pixel, `rows` canvas rows of one image a block.
template <int C1>
__global__ void __launch_bounds__(kFwdMaxThreads)
    render_fwd_kernel(const float* __restrict__ objs, const float* __restrict__ ys,
                      const float* __restrict__ xs, const float* __restrict__ zp,
                      const float* __restrict__ wd, const float* __restrict__ bg,
                      const int* __restrict__ seed, float noise_scale, float* __restrict__ out,
                      float* __restrict__ sums, Shapes s, int rows) {
  constexpr int C = C1 - 1;
  const int tiles = (s.H + rows - 1) / rows;
  const int b = blockIdx.x / tiles;
  const int y = (blockIdx.x - b * tiles) * rows + (int)threadIdx.x / s.W;
  const int x = (int)threadIdx.x % s.W;
  if ((int)threadIdx.x >= rows * s.W || y >= s.H) return;
  const int HW = s.H * s.W, p = y * s.W + x;
  const uint32_t key = (uint32_t)seed[0] + (uint32_t)b;
  float acc[C + 2];  // S1 (C), S2, S3
#pragma unroll
  for (int c = 0; c < C + 2; ++c) acc[c] = 0.f;
  for (int k = 0; k < s.K; ++k) {
    const size_t cell = (size_t)b * s.K + k;
    const Tap ty = make_tap(ys[cell * s.H + y], s.h);
    const Tap tx = make_tap(xs[cell * s.W + x], s.w);
    float v[C1];
    if (ty.in() && tx.in()) {
      Quad<C1> q;
      load_quad<C1>(objs + cell * s.h * s.w * C1, ty, tx, s.w, q);
      paste_quad<C1>(q, ty, tx, v);
    } else {
#pragma unroll
      for (int c = 0; c < C1; ++c) v[c] = 0.f;
    }
    const float z = zp[cell], dw = wd[cell];
    const float alpha = clip(v[C], kEps, 1.f);
    const float transp = z * alpha;
    const float imp = transp * dw;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float val = v[c];
      if (noise_scale > 0.f) val += noise_scale * normal_at(key, (uint32_t)((k * C + c) * HW + p));
      acc[c] += imp * clip(val, 0.f, 1.f);
    }
    acc[C] += imp;
    acc[C + 1] += transp * imp;
  }
  const size_t o = ((size_t)b * HW + p) * C;
  const float d = acc[C] + kEps;
  const float ac = acc[C + 1] / d;
#pragma unroll
  for (int c = 0; c < C; ++c) out[o + c] = ac * (acc[c] / d) + (1.f - ac) * bg[o + c];
  float* sb = sums + (size_t)b * (C + 2) * HW + p;
#pragma unroll
  for (int c = 0; c < C + 2; ++c) sb[c * HW] = acc[c];
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Backward shared memory, in floats: gs [(C+2)][H*W] (the composite's
// gradients), gp [H*W][C1], the pixels' parts of g_ys and g_xs [H*W] each,
// row taps [H] and column taps [W] (4 words a Tap), the canvas ranges of the
// object rows [h] and columns [w] (2 words each), 32 for block sums.
struct Layout {
  int gp, part_y, part_x, rows, cols, range_i, range_j, red, total;
};

__host__ __device__ inline Layout make_layout(int C1, const Shapes& s) {
  const int HW = s.H * s.W;
  Layout l;
  l.gp = round4((C1 + 1) * HW);
  l.part_y = l.gp + C1 * HW;
  l.part_x = l.part_y + HW;
  l.rows = round4(l.part_x + HW);
  l.cols = l.rows + 4 * s.H;
  l.range_i = l.cols + 4 * s.W;
  l.range_j = l.range_i + 2 * s.h;
  l.red = l.range_j + 2 * s.w;
  l.total = l.red + 32;
  return l;
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

// The canvas indices [lo, hi) whose taps t[0..n) include object index i
// (empty: lo >= hi). The coordinates are monotone, so the range holds no
// other index whose taps miss i; the gather checks the weights all the same.
__device__ __forceinline__ int2 tap_range(const Tap* t, int n, int i) {
  int lo = n, hi = 0;
  for (int q = 0; q < n; ++q) {
    const Tap tq = t[q];
    if (tq.in() && (tq.i0 == i || tq.i1 == i)) {
      lo = min(lo, q);
      hi = q + 1;
    }
  }
  return make_int2(lo, hi);
}

__device__ __forceinline__ float tap_weight(const Tap& t, int i) {
  return (t.i0 == i ? t.w0 : 0.f) + (t.i1 == i ? t.w1 : 0.f);
}

template <int C1>
__global__ void __launch_bounds__(kBwdThreads)
    render_bwd_kernel(const float* __restrict__ objs, const float* __restrict__ ys,
                      const float* __restrict__ xs, const float* __restrict__ zp,
                      const float* __restrict__ wd, const float* __restrict__ bg,
                      const int* __restrict__ seed, float noise_scale,
                      const float* __restrict__ sums, const float* __restrict__ gout,
                      float* __restrict__ g_objs, float* __restrict__ g_ys,
                      float* __restrict__ g_xs, float* __restrict__ g_zp,
                      float* __restrict__ g_wd, float* __restrict__ g_bg, Shapes s, int cpb) {
  constexpr int C = C1 - 1;
  extern __shared__ __align__(16) float smem[];
  const Layout l = make_layout(C1, s);
  const int groups = (s.K + cpb - 1) / cpb;
  const int b = blockIdx.x / groups, k0 = (blockIdx.x - b * groups) * cpb;
  const int k1 = min(s.K, k0 + cpb);
  const int HW = s.H * s.W;
  const uint32_t key = (uint32_t)seed[0] + (uint32_t)b;
  float* gs = smem;  // g_S1 (C planes), g_S2, g_S3
  float* gp = smem + l.gp;
  float* part_y = smem + l.part_y;
  float* part_x = smem + l.part_x;
  Tap* rows = reinterpret_cast<Tap*>(smem + l.rows);
  Tap* cols = reinterpret_cast<Tap*>(smem + l.cols);
  int2* range_i = reinterpret_cast<int2*>(smem + l.range_i);
  int2* range_j = reinterpret_cast<int2*>(smem + l.range_j);

  // The composite's gradients of every pixel, from the forward's sums.
  const float* sb = sums + (size_t)b * (C + 2) * HW;
  for (int p = threadIdx.x; p < HW; p += blockDim.x) {
    const float s2 = sb[C * HW + p], s3 = sb[(C + 1) * HW + p];
    const float inv_d = 1.f / (s2 + kEps), inv_d2 = inv_d * inv_d;
    const size_t o = ((size_t)b * HW + p) * C;
    float gs2 = 0.f, gs3 = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const float g = gout[o + c], s1 = sb[c * HW + p], bgv = bg[o + c];
      gs3 += g * (s1 * inv_d2 - bgv * inv_d);
      gs2 += g * (-2.f * s1 * (s3 * inv_d2 * inv_d) + bgv * (s3 * inv_d2));
      if (k0 == 0) g_bg[o + c] = g * (1.f - s3 * inv_d);
      gs[c * HW + p] = g * (s3 * inv_d2);
    }
    gs[C * HW + p] = gs2;
    gs[(C + 1) * HW + p] = gs3;
  }

  for (int k = k0; k < k1; ++k) {
    const size_t cell = (size_t)b * s.K + k;
    for (int e = threadIdx.x; e < s.H + s.W; e += blockDim.x) {
      if (e < s.H)
        rows[e] = make_tap(ys[cell * s.H + e], s.h);
      else
        cols[e - s.H] = make_tap(xs[cell * s.W + e - s.H], s.w);
    }
    __syncthreads();  // the taps (and, at the first cell, gs) are complete
    for (int e = threadIdx.x; e < s.h + s.w; e += blockDim.x) {
      if (e < s.h)
        range_i[e] = tap_range(rows, s.H, e);
      else
        range_j[e - s.h] = tap_range(cols, s.W, e - s.h);
    }
    // A thread a pixel: recompute the paste and the noise, push the gradient
    // through the composite.
    const float* obj = objs + cell * s.h * s.w * C1;
    const float z = zp[cell], dw = wd[cell];
    float part_zp = 0.f, part_wd = 0.f;
    for (int p = threadIdx.x; p < HW; p += blockDim.x) {
      const int y = p / s.W, x = p - y * s.W;
      const Tap ty = rows[y], tx = cols[x];
      const bool in = ty.in() && tx.in();
      Quad<C1> q;
      float v[C1];
      if (in) {
        load_quad<C1>(obj, ty, tx, s.w, q);
        paste_quad<C1>(q, ty, tx, v);
      } else {
#pragma unroll
        for (int c = 0; c < C1; ++c) v[c] = 0.f;
      }
      const float alpha_raw = v[C];
      const float alpha = clip(alpha_raw, kEps, 1.f);
      const float transp = z * alpha;
      const float imp = transp * dw;
      const float gs2 = gs[C * HW + p], gs3 = gs[(C + 1) * HW + p];
      float g_imp = gs2 + gs3 * transp;
      float g[C1];
#pragma unroll
      for (int c = 0; c < C; ++c) {
        float val = v[c];
        if (noise_scale > 0.f) val += noise_scale * normal_at(key, (uint32_t)((k * C + c) * HW + p));
        const float rgb = clip(val, 0.f, 1.f);
        const float gs1 = gs[c * HW + p];
        g_imp += gs1 * rgb;
        g[c] = (rgb > 0.f && rgb < 1.f) ? gs1 * imp : 0.f;
      }
      const float g_transp = gs3 * imp;
      const bool alpha_in = alpha_raw > kEps && alpha_raw < 1.f;
      g[C] = alpha_in ? (g_imp * (z * dw) + g_transp * z) : 0.f;
      part_zp += g_imp * alpha * dw + g_transp * alpha;
      part_wd += g_imp * z * alpha;
      Px<C1>::put(gp + p * C1, g);
      float py = 0.f, px = 0.f;
      if (in) {
#pragma unroll
        for (int c = 0; c < C1; ++c) {
          py += g[c] * (tx.w0 * (q.c[c] - q.a[c]) + tx.w1 * (q.d[c] - q.b[c]));
          px += g[c] * (ty.w0 * (q.b[c] - q.a[c]) + ty.w1 * (q.d[c] - q.c[c]));
        }
      }
      part_y[p] = py;
      part_x[p] = px;
    }
    const float sum_zp = block_sum(part_zp, smem + l.red);
    const float sum_wd = block_sum(part_wd, smem + l.red);
    if (threadIdx.x == 0) {
      g_zp[cell] = sum_zp;
      g_wd[cell] = sum_wd;
    }
    // block_sum ends in __syncthreads(): gp, the parts and the ranges are
    // complete. g_obj: a thread an object pixel, columns first, then rows.
    float* go = g_objs + cell * s.h * s.w * C1;
    for (int e = threadIdx.x; e < s.h * s.w; e += blockDim.x) {
      const int i = e / s.w, j = e - i * s.w;
      const int2 ri = range_i[i], rj = range_j[j];
      float acc[C1];
#pragma unroll
      for (int c = 0; c < C1; ++c) acc[c] = 0.f;
      for (int y = ri.x; y < ri.y; ++y) {
        float t[C1];
#pragma unroll
        for (int c = 0; c < C1; ++c) t[c] = 0.f;
        for (int x = rj.x; x < rj.y; ++x) {
          const float wx = tap_weight(cols[x], j);
          float gv[C1];
          Px<C1>::get(gp + (y * s.W + x) * C1, gv);
#pragma unroll
          for (int c = 0; c < C1; ++c) t[c] = fmaf(wx, gv[c], t[c]);
        }
        const float wy = tap_weight(rows[y], i);
#pragma unroll
        for (int c = 0; c < C1; ++c) acc[c] = fmaf(wy, t[c], acc[c]);
      }
      Px<C1>::put(go + e * C1, acc);
    }
    // g_ys: a thread a canvas row, over x in order; g_xs: a thread a column.
    for (int e = threadIdx.x; e < s.H + s.W; e += blockDim.x) {
      float sum = 0.f;
      if (e < s.H) {
        for (int x = 0; x < s.W; ++x) sum += part_y[e * s.W + x];
        g_ys[cell * s.H + e] = sum;
      } else {
        const int x = e - s.H;
        for (int y = 0; y < s.H; ++y) sum += part_x[y * s.W + x];
        g_xs[cell * s.W + x] = sum;
      }
    }
    __syncthreads();  // the next cell overwrites the taps, gp and the parts
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
cudaError_t launch_fwd(const float* objs, const float* ys, const float* xs, const float* zp,
                       const float* wd, const float* bg, const int* seed, float noise_scale,
                       float* out, float* sums, int B, const Shapes& s, int rows,
                       cudaStream_t stream) {
  if (s.W > kFwdMaxThreads || rows < 1) return cudaErrorInvalidValue;
  rows = min(rows, kFwdMaxThreads / s.W);
  const int tiles = (s.H + rows - 1) / rows;
  const int threads = (rows * s.W + 31) / 32 * 32;
  render_fwd_kernel<C1><<<B * tiles, threads, 0, stream>>>(objs, ys, xs, zp, wd, bg, seed,
                                                            noise_scale, out, sums, s, rows);
  return cudaGetLastError();
}

template <int C1>
cudaError_t launch_bwd(const float* objs, const float* ys, const float* xs, const float* zp,
                       const float* wd, const float* bg, const int* seed, float noise_scale,
                       const float* sums, const float* g, float* g_objs, float* g_ys,
                       float* g_xs, float* g_zp, float* g_wd, float* g_bg, int B,
                       const Shapes& s, int cpb, cudaStream_t stream) {
  if (cpb < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * make_layout(C1, s).total;
  cudaError_t err = cudaFuncSetAttribute(render_bwd_kernel<C1>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (s.K + cpb - 1) / cpb;
  render_bwd_kernel<C1><<<B * groups, kBwdThreads, smem, stream>>>(
      objs, ys, xs, zp, wd, bg, seed, noise_scale, sums, g, g_objs, g_ys, g_xs, g_zp, g_wd,
      g_bg, s, cpb);
  return cudaGetLastError();
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
  const Shapes s{K, h, w, H, W};
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return launch_fwd<2>(objs, ys, xs, zp, wd, bg, seed, noise_scale, out, sums, B, s, rows,
                           st);
    case 3:
      return launch_fwd<4>(objs, ys, xs, zp, wd, bg, seed, noise_scale, out, sums, B, s, rows,
                           st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// sums: the forward's; g [B,H,W,C] -> g_objs, g_ys, g_xs, g_zp, g_wd, g_bg
// shaped as their inputs; `cpb` cells a block.
int render_bwd(const float* objs, const float* ys, const float* xs, const float* zp,
               const float* wd, const float* bg, const int* seed, float noise_scale,
               const float* sums, const float* g, float* g_objs, float* g_ys, float* g_xs,
               float* g_zp, float* g_wd, float* g_bg, int B, int K, int h, int w, int H, int W,
               int C, int cpb, void* stream) {
  const Shapes s{K, h, w, H, W};
  cudaStream_t st = (cudaStream_t)stream;
  switch (C) {
    case 1:
      return launch_bwd<2>(objs, ys, xs, zp, wd, bg, seed, noise_scale, sums, g, g_objs, g_ys,
                           g_xs, g_zp, g_wd, g_bg, B, s, cpb, st);
    case 3:
      return launch_bwd<4>(objs, ys, xs, zp, wd, bg, seed, noise_scale, sums, g, g_objs, g_ys,
                           g_xs, g_zp, g_wd, g_bg, B, s, cpb, st);
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
