// The render kernel pair, shared by the full-canvas render (render.cu) and
// the row-windowed render (render_windowed.cu): the taps of a sample
// coordinate, the load and paste of a canvas pixel's four object pixels, the
// backward's shared-memory layout and its fixed-order block sums, and one
// forward and one backward body with a flag, kBanded. Without it the bodies
// are the full-canvas pair (render.cu's header states the function and the
// design); with it each cell's terms are confined to its row band, found in
// the kernel (find_band), and the rows outside get their closed-form terms
// (render_windowed.cu's header). Each source instantiates its own flag.
//
// Channels: the instances for C = 1 and C = 3 (C1 = C + 1 = 2, 4) keep a
// pixel in registers and load it as one 8- or 16-byte access. The general
// instance (kC1 = 0) takes C1 from Shapes, loads channel by channel and keeps
// its per-channel arrays at the size of kMaxChannels + 1 (in local memory).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "philox.cuh"

namespace {

constexpr float kEps = 1e-8f;
// The most colour channels the general instance takes (kernels/render.py::
// MAX_CHANNELS, checked by the wrappers).
constexpr int kMaxChannels = 8;

// The size of a per-channel array of the instance kC1 (0: the general one).
template <int kC1>
struct Ch {
  static constexpr int n = kC1 ? kC1 : kMaxChannels + 1;
};

// The instance for C colour channels: C1 = 2 or 4 for C = 1 or 3, 0 (the
// general one) for any other C from 1 to kMaxChannels, -1 for a C refused.
inline int instance(int C) {
  return C == 1 ? 2 : C == 3 ? 4 : (C >= 1 && C <= kMaxChannels) ? 0 : -1;
}

__device__ __forceinline__ float clip(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

struct Shapes {
  int K, h, w, H, W, C1;
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

// A pixel of the instance kC1: Px's wide access, or C1 scalar ones (kC1 = 0).
template <int kC1>
__device__ __forceinline__ void px_load(const float* p, float* v, int C1) {
  if constexpr (kC1 > 0) {
    Px<kC1>::load(p, v);
  } else {
    for (int c = 0; c < C1; ++c) v[c] = __ldg(p + c);
  }
}

template <int kC1>
__device__ __forceinline__ void px_get(const float* p, float* v, int C1) {
  if constexpr (kC1 > 0) {
    Px<kC1>::get(p, v);
  } else {
    for (int c = 0; c < C1; ++c) v[c] = p[c];
  }
}

template <int kC1>
__device__ __forceinline__ void px_put(float* p, const float* v, int C1) {
  if constexpr (kC1 > 0) {
    Px<kC1>::put(p, v);
  } else {
    for (int c = 0; c < C1; ++c) p[c] = v[c];
  }
}

// The four taps of a canvas pixel whose row and column taps both lie in the
// object: a = obj[i0][j0], b = obj[i0][j1], c = obj[i1][j0], d = obj[i1][j1].
template <int kC1>
struct Quad {
  float a[Ch<kC1>::n], b[Ch<kC1>::n], c[Ch<kC1>::n], d[Ch<kC1>::n];
};

template <int kC1>
__device__ __forceinline__ void load_quad(const float* __restrict__ obj, const Tap& ty,
                                          const Tap& tx, int w, int C1, Quad<kC1>& q) {
  px_load<kC1>(obj + (ty.i0 * w + tx.i0) * C1, q.a, C1);
  px_load<kC1>(obj + (ty.i0 * w + tx.i1) * C1, q.b, C1);
  px_load<kC1>(obj + (ty.i1 * w + tx.i0) * C1, q.c, C1);
  px_load<kC1>(obj + (ty.i1 * w + tx.i1) * C1, q.d, C1);
}

// The paste with the dense products' roundings: rows first, the i0 product
// and an FMA of the i1 one onto it, then columns the same way.
template <int kC1>
__device__ __forceinline__ void paste_quad(const Quad<kC1>& q, const Tap& ty, const Tap& tx,
                                           int C1, float* v) {
#pragma unroll
  for (int c = 0; c < C1; ++c) {
    const float left = fmaf(ty.w1, q.c[c], ty.w0 * q.a[c]);
    const float right = fmaf(ty.w1, q.d[c], ty.w0 * q.b[c]);
    v[c] = fmaf(tx.w1, right, tx.w0 * left);
  }
}

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Backward shared memory, in floats: gs [(C+2)][H*W] (the composite's
// gradients), gp [H*W][C1], the pixels' parts of g_ys and g_xs [H*W] each,
// row taps [H] and column taps [W] (4 words a Tap), the canvas ranges of the
// object rows [h] and columns [w] (2 words each), 4 x 32 for block sums.
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
  l.total = l.red + 4 * 32;
  return l;
}

// Sums each of v[0..N) over the block, with one pair of barriers for all N;
// the results are valid in thread 0. Uses red[0 .. 32*N).
template <int N>
__device__ void block_sums(float* v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v[n] += __shfl_down_sync(0xffffffffu, v[n], o);
    if (lane == 0) red[n * 32 + warp] = v[n];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) {
      float t = (lane < (int)(blockDim.x >> 5)) ? red[n * 32 + lane] : 0.f;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) t += __shfl_down_sync(0xffffffffu, t, o);
      v[n] = t;
    }
  }
  __syncthreads();
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

constexpr int kFwdMaxThreads = 512;
constexpr int kBwdThreads = 256;

// The row band [start, end) of one cell from its row coordinates y[0..H), for
// an object of h rows: compute_bands's rule (kernels/render_windowed.py), a
// ballot a 32 rows. Called by a whole warp; the result is valid in every lane.
__device__ __forceinline__ int2 find_band(const float* __restrict__ y, int H, int h) {
  const int lane = threadIdx.x & 31;
  int first = H, last = -1;
  for (int base = 0; base < H; base += 32) {
    const int r = base + lane;
    bool v = false;
    if (r < H) {
      const float u = y[r];
      v = u > -1.f && u < (float)h;
    }
    const unsigned m = __ballot_sync(0xffffffffu, v);
    if (m != 0u) {
      if (first == H) first = base + __ffs(m) - 1;
      last = base + 31 - __clz(m);
    }
  }
  if (last < 0) return make_int2(0, 0);
  return make_int2(max(first - 1, 0), min(last + 2, H));
}

// A thread a canvas pixel, `rows` canvas rows of one image a block. Banded:
// the block's warps first find the image's K bands (dynamic shared memory);
// outside a cell's band a thread adds nothing, and the cells' closed-form
// terms are added once at the end.
template <int kC1, bool kBanded>
__global__ void __launch_bounds__(kFwdMaxThreads)
    render_fwd_kernel(const float* __restrict__ objs, const float* __restrict__ ys,
                      const float* __restrict__ xs, const float* __restrict__ zp,
                      const float* __restrict__ wd, const float* __restrict__ bg,
                      const int* __restrict__ seed, float noise_scale, float* __restrict__ out,
                      float* __restrict__ sums, Shapes s, int rows) {
  extern __shared__ int2 bands[];
  const int C1 = kC1 ? kC1 : s.C1, C = C1 - 1;
  const int tiles = (s.H + rows - 1) / rows;
  const int b = blockIdx.x / tiles;
  if constexpr (kBanded) {
    const int warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
    for (int k = warp; k < s.K; k += warps) {
      const int2 band = find_band(ys + ((size_t)b * s.K + k) * s.H, s.H, s.h);
      if ((threadIdx.x & 31) == 0) bands[k] = band;
    }
    __syncthreads();
  }
  const int y = (blockIdx.x - b * tiles) * rows + (int)threadIdx.x / s.W;
  const int x = (int)threadIdx.x % s.W;
  if ((int)threadIdx.x >= rows * s.W || y >= s.H) return;
  const int HW = s.H * s.W, p = y * s.W + x;
  const uint32_t key = (uint32_t)seed[0] + (uint32_t)b;
  float acc[Ch<kC1>::n + 1];  // S1 (C), S2, S3 (banded: the in-band terms)
#pragma unroll
  for (int c = 0; c < C + 2; ++c) acc[c] = 0.f;
  float c2_sum = 0.f, c3_sum = 0.f;  // banded: the closed-form terms of every cell
  for (int k = 0; k < s.K; ++k) {
    const size_t cell = (size_t)b * s.K + k;
    const float z = zp[cell], dw = wd[cell];
    float c2 = 0.f, c3 = 0.f;
    if constexpr (kBanded) {
      c2 = z * dw * kEps;
      c3 = z * z * dw * (kEps * kEps);
      c2_sum += c2;
      c3_sum += c3;
      const int2 band = bands[k];
      if (y < band.x || y >= band.y) continue;
    }
    const Tap ty = make_tap(ys[cell * s.H + y], s.h);
    const Tap tx = make_tap(xs[cell * s.W + x], s.w);
    float v[Ch<kC1>::n];
    if (ty.in() && tx.in()) {
      Quad<kC1> q;
      load_quad<kC1>(objs + cell * s.h * s.w * C1, ty, tx, s.w, C1, q);
      paste_quad<kC1>(q, ty, tx, C1, v);
    } else {
#pragma unroll
      for (int c = 0; c < C1; ++c) v[c] = 0.f;
    }
    const float alpha = clip(v[C], kEps, 1.f);
    const float transp = z * alpha;
    const float imp = transp * dw;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float val = v[c];
      if (noise_scale > 0.f) val += noise_scale * normal_at(key, (uint32_t)((k * C + c) * HW + p));
      acc[c] += imp * clip(val, 0.f, 1.f);
    }
    if constexpr (kBanded) {
      acc[C] += imp - c2;
      acc[C + 1] += transp * imp - c3;
    } else {
      acc[C] += imp;
      acc[C + 1] += transp * imp;
    }
  }
  if constexpr (kBanded) {
    acc[C] += c2_sum;
    acc[C + 1] += c3_sum;
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

// `cpb` cells of one image a block. Banded: warp 0 finds each cell's band,
// the pixel phase and the g_ys, g_xs sums take the band's rows only, and
// g_zp, g_wd get the rows outside it from the full-canvas sums of g_S2, g_S3.
template <int kC1, bool kBanded>
__global__ void __launch_bounds__(kBwdThreads)
    render_bwd_kernel(const float* __restrict__ objs, const float* __restrict__ ys,
                      const float* __restrict__ xs, const float* __restrict__ zp,
                      const float* __restrict__ wd, const float* __restrict__ bg,
                      const int* __restrict__ seed, float noise_scale,
                      const float* __restrict__ sums, const float* __restrict__ gout,
                      float* __restrict__ g_objs, float* __restrict__ g_ys,
                      float* __restrict__ g_xs, float* __restrict__ g_zp,
                      float* __restrict__ g_wd, float* __restrict__ g_bg, Shapes s, int cpb) {
  const int C1 = kC1 ? kC1 : s.C1, C = C1 - 1;
  extern __shared__ __align__(16) float smem[];
  __shared__ int2 s_band;
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
  float* red = smem + l.red;

  // The composite's gradients of every pixel, from the forward's sums (and,
  // banded, their full-canvas sums of g_S2 and g_S3, valid in thread 0).
  const float* sb = sums + (size_t)b * (C + 2) * HW;
  float full[2] = {0.f, 0.f};
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
    if constexpr (kBanded) {
      full[0] += gs2;
      full[1] += gs3;
    }
  }
  if constexpr (kBanded) block_sums<2>(full, red);

  for (int k = k0; k < k1; ++k) {
    const size_t cell = (size_t)b * s.K + k;
    for (int e = threadIdx.x; e < s.H + s.W; e += blockDim.x) {
      if (e < s.H)
        rows[e] = make_tap(ys[cell * s.H + e], s.h);
      else
        cols[e - s.H] = make_tap(xs[cell * s.W + e - s.H], s.w);
    }
    if constexpr (kBanded) {
      if (threadIdx.x < 32) {
        const int2 band = find_band(ys + cell * s.H, s.H, s.h);
        if (threadIdx.x == 0) s_band = band;
      }
    }
    __syncthreads();  // the taps, the band (and, at the first cell, gs) are complete
    int start = 0, end = s.H;
    if constexpr (kBanded) {
      start = s_band.x;
      end = s_band.y;
    }
    // The canvas ranges of the object rows (among the band's rows: no row
    // outside the band has two taps in the object) and of the object columns.
    for (int e = threadIdx.x; e < s.h + s.w; e += blockDim.x) {
      if (e < s.h) {
        const int2 r = tap_range(rows + start, end - start, e);
        range_i[e] = make_int2(start + r.x, start + r.y);
      } else {
        range_j[e - s.h] = tap_range(cols, s.W, e - s.h);
      }
    }
    // A thread a (band) pixel: recompute the paste and the noise, push the
    // gradient through the composite.
    const float* obj = objs + cell * s.h * s.w * C1;
    const float z = zp[cell], dw = wd[cell];
    float part[4] = {0.f, 0.f, 0.f, 0.f};  // g_zp, g_wd; banded: the band's g_S2, g_S3
    for (int p = start * s.W + threadIdx.x; p < end * s.W; p += blockDim.x) {
      const int y = p / s.W, x = p - y * s.W;
      const Tap ty = rows[y], tx = cols[x];
      const bool in = ty.in() && tx.in();
      Quad<kC1> q;
      float v[Ch<kC1>::n];
      if (in) {
        load_quad<kC1>(obj, ty, tx, s.w, C1, q);
        paste_quad<kC1>(q, ty, tx, C1, v);
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
      float g[Ch<kC1>::n];
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
      part[0] += g_imp * alpha * dw + g_transp * alpha;
      part[1] += g_imp * z * alpha;
      if constexpr (kBanded) {
        part[2] += gs2;
        part[3] += gs3;
      }
      px_put<kC1>(gp + p * C1, g, C1);
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
    block_sums<kBanded ? 4 : 2>(part, red);
    if (threadIdx.x == 0) {
      if constexpr (kBanded) {
        // The band's exact terms plus the 1e-8-scale terms of the rows outside
        // it, where alpha is 1e-8 (1e-16 cross terms dropped).
        const float out2 = full[0] - part[2], out3 = full[1] - part[3];
        g_zp[cell] = part[0] + kEps * (dw * out2 + 2.f * z * dw * kEps * out3);
        g_wd[cell] = part[1] + kEps * z * out2 + (kEps * kEps) * z * z * out3;
      } else {
        g_zp[cell] = part[0];
        g_wd[cell] = part[1];
      }
    }
    // block_sums ends in __syncthreads(): gp, the parts and the ranges are
    // complete. g_obj: a thread an object pixel, columns first, then rows.
    float* go = g_objs + cell * s.h * s.w * C1;
    for (int e = threadIdx.x; e < s.h * s.w; e += blockDim.x) {
      const int i = e / s.w, j = e - i * s.w;
      const int2 ri = range_i[i], rj = range_j[j];
      float acc[Ch<kC1>::n];
#pragma unroll
      for (int c = 0; c < C1; ++c) acc[c] = 0.f;
      for (int y = ri.x; y < ri.y; ++y) {
        float t[Ch<kC1>::n];
#pragma unroll
        for (int c = 0; c < C1; ++c) t[c] = 0.f;
        for (int x = rj.x; x < rj.y; ++x) {
          const float wx = tap_weight(cols[x], j);
          float gv[Ch<kC1>::n];
          px_get<kC1>(gp + (y * s.W + x) * C1, gv, C1);
#pragma unroll
          for (int c = 0; c < C1; ++c) t[c] = fmaf(wx, gv[c], t[c]);
        }
        const float wy = tap_weight(rows[y], i);
#pragma unroll
        for (int c = 0; c < C1; ++c) acc[c] = fmaf(wy, t[c], acc[c]);
      }
      px_put<kC1>(go + e * C1, acc, C1);
    }
    // g_ys: a thread a canvas row, over x in order (banded: 0 outside the
    // band); g_xs: a thread a column, over the (band's) rows in order.
    for (int e = threadIdx.x; e < s.H + s.W; e += blockDim.x) {
      float sum = 0.f;
      if (e < s.H) {
        if (e >= start && e < end)
          for (int x = 0; x < s.W; ++x) sum += part_y[e * s.W + x];
        g_ys[cell * s.H + e] = sum;
      } else {
        const int x = e - s.H;
        for (int y = start; y < end; ++y) sum += part_x[y * s.W + x];
        g_xs[cell * s.W + x] = sum;
      }
    }
    __syncthreads();  // the next cell overwrites the taps, the band, gp and the parts
  }
}

template <int kC1, bool kBanded>
cudaError_t launch_fwd(const float* objs, const float* ys, const float* xs, const float* zp,
                       const float* wd, const float* bg, const int* seed, float noise_scale,
                       float* out, float* sums, int B, const Shapes& s, int rows,
                       cudaStream_t stream) {
  if (s.W > kFwdMaxThreads || rows < 1) return cudaErrorInvalidValue;
  rows = min(rows, kFwdMaxThreads / s.W);
  const int tiles = (s.H + rows - 1) / rows;
  const int threads = (rows * s.W + 31) / 32 * 32;
  const size_t smem = kBanded ? sizeof(int2) * s.K : 0;
  render_fwd_kernel<kC1, kBanded><<<B * tiles, threads, smem, stream>>>(
      objs, ys, xs, zp, wd, bg, seed, noise_scale, out, sums, s, rows);
  return cudaGetLastError();
}

template <int kC1, bool kBanded>
cudaError_t launch_bwd(const float* objs, const float* ys, const float* xs, const float* zp,
                       const float* wd, const float* bg, const int* seed, float noise_scale,
                       const float* sums, const float* g, float* g_objs, float* g_ys,
                       float* g_xs, float* g_zp, float* g_wd, float* g_bg, int B,
                       const Shapes& s, int cpb, cudaStream_t stream) {
  if (cpb < 1) return cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * make_layout(s.C1, s).total;
  cudaError_t err = cudaFuncSetAttribute(render_bwd_kernel<kC1, kBanded>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int groups = (s.K + cpb - 1) / cpb;
  render_bwd_kernel<kC1, kBanded><<<B * groups, kBwdThreads, smem, stream>>>(
      objs, ys, xs, zp, wd, bg, seed, noise_scale, sums, g, g_objs, g_ys, g_xs, g_zp, g_wd,
      g_bg, s, cpb);
  return cudaGetLastError();
}

// The forward of C colour channels: objs [B,K,h,w,C+1], ys [B,K,H], xs
// [B,K,W], zp/wd [B,K], bg/out [B,H,W,C], sums [B,C+2,H,W]; `rows` canvas
// rows a block. Returns the launch's cudaError_t.
template <bool kBanded>
int render_fwd_any(const float* objs, const float* ys, const float* xs, const float* zp,
                   const float* wd, const float* bg, const int* seed, float noise_scale,
                   float* out, float* sums, int B, int K, int h, int w, int H, int W, int C,
                   int rows, void* stream) {
  const Shapes s{K, h, w, H, W, C + 1};
  cudaStream_t st = (cudaStream_t)stream;
#define RENDER_FWD(kC1)                                                                       \
  launch_fwd<kC1, kBanded>(objs, ys, xs, zp, wd, bg, seed, noise_scale, out, sums, B, s, rows, \
                           st)
  switch (instance(C)) {
    case 2: return RENDER_FWD(2);
    case 4: return RENDER_FWD(4);
    case 0: return RENDER_FWD(0);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RENDER_FWD
}

// The backward: sums the forward's, g [B,H,W,C] -> g_objs, g_ys, g_xs, g_zp,
// g_wd, g_bg shaped as their inputs; `cpb` cells a block.
template <bool kBanded>
int render_bwd_any(const float* objs, const float* ys, const float* xs, const float* zp,
                   const float* wd, const float* bg, const int* seed, float noise_scale,
                   const float* sums, const float* g, float* g_objs, float* g_ys, float* g_xs,
                   float* g_zp, float* g_wd, float* g_bg, int B, int K, int h, int w, int H,
                   int W, int C, int cpb, void* stream) {
  const Shapes s{K, h, w, H, W, C + 1};
  cudaStream_t st = (cudaStream_t)stream;
#define RENDER_BWD(kC1)                                                                       \
  launch_bwd<kC1, kBanded>(objs, ys, xs, zp, wd, bg, seed, noise_scale, sums, g, g_objs, g_ys, \
                           g_xs, g_zp, g_wd, g_bg, B, s, cpb, st)
  switch (instance(C)) {
    case 2: return RENDER_BWD(2);
    case 4: return RENDER_BWD(4);
    case 0: return RENDER_BWD(0);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RENDER_BWD
}

}  // namespace
