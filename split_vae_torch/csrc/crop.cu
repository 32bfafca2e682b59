// STN glimpse crop for SPAIR as a four-tap gather from the sample
// coordinates, forward and backward.
//
// Replaces the Pallas TPU kernel pairs tools/pallas_research/crop_fused.py
// (_fwd_kernel:33, _bwd_kernel:42) and tools/pallas_research/crop_packed.py
// (_fwd_kernel:64, _bwd_kernel:80). Those take dense interpolation matrices
// wy [B,K,ho,H] and wx [B,K,wo,W] and multiply them out on the MXU. Every row
// of wy and wx holds at most two non-zeros, so this pair takes the sample
// coordinates ys [B,K,ho] and xs [B,K,wo] instead and gathers four taps an
// output: one pair for any H, W, ho, wo, C and K.
//
// The function. The taps of a coordinate u on an axis of length n are those
// of _interp_matrix (split_vae_tpu/ops/stn.py:105), computed in fp32 with the
// same operations:
//   x0 = floor(u); i0 = clamp(x0, 0, n-1); i1 = clamp(x0 + 1, 0, n-1)
//   w0 = i1 - u (weight on i0), w1 = u - i0 (weight on i1)
//   out[b,k,p,q,c] = sum_{a,e in {0,1}} wy_a[p] wx_e[q] img[b, iy_a[p], jx_e[q], c]
// The out-of-image rule: where the two clamped indices coincide (u in (-1, 0),
// u >= n-1, or further out), the dense row is w0 + w1 at i0, and that is
// exactly 0 in fp32 ((i - u) and (u - i) round to exact negatives), as is its
// gradient. The kernels set both weights to 0 there, so a sample at exactly
// n-1 gives 0, not img[n-1]. This is the reference's clipping
// (spair/utils.py:229-246). F.grid_sample with padding_mode="zeros" computes
// another function at the border: it is neither a yardstick nor a stand-in.
//
// Gradients, as autograd finds them through _interp_matrix and the dense crop
// (floor and clamp carry none; d w0/du = -1, d w1/du = +1):
//   g_ys[p] = sum_{q,c} g[p,q,c] sum_e wx_e[q] (img[iy_1, jx_e, c] - img[iy_0, jx_e, c])
//   g_xs[q] = sum_{p,c} g[p,q,c] sum_a wy_a[p] (img[iy_a, jx_1, c] - img[iy_a, jx_0, c])
//   g_img   = the transpose of the gather.
// Where the taps coincide the two offsets are equal and the difference is 0.
// The dense g_wy and g_wx are never formed: nothing downstream reads more of
// them than the two taps of a row.
//
// What bounds it on an H100 SXM (3.35 TB/s, 700 W; B=256, K=16, 48 -> 32 px,
// C=3, fp32): bytes. The forward reads img 7.08 MB and ys, xs 1.05 MB and
// writes 50.33 MB: 17.45 us. The backward that the model's path calls reads
// g, img, ys and xs and writes g_ys and g_xs: 59.51 MB, 17.76 us; with g_img
// 66.58 MB, 19.88 us. The arithmetic (9 FLOP an output forward, about 12 an
// element of g backward) is a few microseconds at 67 TFLOP/s.
//
// Design. What held the first versions back was instruction throughput,
// not memory: with its stores taken out, the forward still took longer than
// torch takes to fill the output it writes. So the design spends few
// instructions an output:
//   - A block stages one image, [H][W*C] as it lies in device memory (27.6 KB
//     at 48 px), in shared memory with 16-byte cp.async copies, and computes
//     its cells' taps (shared offsets and weights of ho rows and wo columns)
//     while the copy is in flight.
//   - A warp takes a group of kRows = 4 consecutive output rows of a cell at
//     a time; lane q takes column q (and q + 32, ... up to 128 columns: the
//     kernels are instantiated for 1, 2 and 4 column slots) and keeps its
//     column taps in registers while the cell lasts. A warp's taps fall on
//     distinct pixels C floats apart, or on the same one, so each of the four
//     image loads of an output is one conflict-free shared access. The
//     kernels are also instantiated for C = 3, so that the channel loop
//     unrolls into loads at fixed offsets from four addresses a pixel; other
//     channel counts take a loop.
//   - Forward: three multiplies and three FMAs an output, in the order and
//     with the roundings of the dense products (rows, then columns; the
//     first of the two non-zero terms a product, the second an FMA onto it;
//     the zeros add nothing). So the glimpse is bit-equal to the plain
//     version's (crop_taps_reference: einsums that sum in that order). That
//     matters: a random-weight model has pre-activations within 1e-8 of 0,
//     and a glimpse an ulp off flips a ReLU: the card-vs-CPU small step of
//     chip_smoke.py then differs by 3e-3 of max|g| where it agrees to 1e-5
//     (BG-SPAIR, H100 80GB HBM3 at 700 W).
//     The group, kRows*wo*C floats in a row in the output, is then stored in
//     order, 16 bytes a lane where wo*C is a multiple of 4 (96 at 32 px, 84
//     at 28), else 4.
//   - Backward: the warp reads its groups of g with 16-byte cp.async copies
//     through a ring of kStages = 2 buffers, one group ahead of the one it
//     computes. A lane sums its four taps against g over the channels, then
//     forms the two partials a pixel. A group's four g_ys sums take one
//     transposed shuffle reduction (6 shuffles, not 20), and each lane keeps
//     its g_xs partial in a register while the cell lasts; the warps' column
//     partials then add in warp order. No atomics: the result is the same
//     from run to run.
//   - With g_img (no path of the model asks for it: the crop's image is the
//     input batch): one block an image takes all its cells and adds each
//     cell's scatter into a shared g_img in cell order. A thread owns a row
//     and channel of t[p][j][c] = sum_q over the column taps on j and walks q
//     in order; then a thread owns a column (j, c) of g_img and walks p in
//     order over the row taps. Again no atomics.
//   - Cells a block: the wrapper's CELLS_PER_BLOCK_FWD and _BWD, from the
//     sweep in chip_smoke.py::time_crop. Several blocks of 35-60 KB fit an
//     SM, and an image staged by several blocks costs L2 reads only (7 MB in
//     all).
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (split_vae_torch/kernels/crop.py loads it with ctypes).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;    // output rows a warp takes at a time: one group
constexpr int kStages = 2;  // groups of g rows a warp has in flight or in use (backward)

struct Shapes {
  int K, H, W, ho, wo, C;
};

// The two taps of one sample: offsets into the staged image (row offsets
// count W*C floats a row, column offsets C) and their weights, 0 where the
// taps coincide.
struct Tap {
  int o0, o1;
  float w0, w1;
};

__host__ __device__ inline int round4(int n) { return (n + 3) & ~3; }

// Shared-memory layout, in floats: img [H*W*C], row taps [cpb*ho], column
// taps [cpb*wo] (a Tap is 4 floats), buffers of kRows rows of wo*C a warp
// (one forward, kStages backward), and for the backward the column partials
// [cpb][kWarps][wo] and, with g_img, t [ho*W*C] and the g_img sum [H*W*C].
struct Layout {
  int rows, cols, stage, ld_stage, colpart, t, gimg, total;
};

__host__ __device__ inline Layout make_layout(const Shapes& s, int cpb, bool bwd,
                                              bool with_gimg) {
  Layout l;
  const int n_img = s.H * s.W * s.C;
  l.rows = round4(n_img);
  l.cols = l.rows + 4 * cpb * s.ho;
  l.stage = l.cols + 4 * cpb * s.wo;
  l.ld_stage = round4(kRows * s.wo * s.C);
  l.colpart = l.stage + kWarps * (bwd ? kStages : 1) * l.ld_stage;
  l.t = l.colpart + (bwd ? round4(cpb * kWarps * s.wo) : 0);
  l.gimg = l.t + (with_gimg ? round4(s.ho * s.W * s.C) : 0);
  l.total = l.gimg + (with_gimg ? n_img : 0);
  return l;
}

// Starts 16-byte asynchronous copies of n floats (n a multiple of 4, both
// ends 16-byte aligned) by threads first, first + step, ...
__device__ inline void copy_async(const float* __restrict__ src, float* dst, int n, int first,
                                  int step) {
  const unsigned base = (unsigned)__cvta_generic_to_shared(dst);
  for (int v = first; v < n / 4; v += step)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(base + 16u * v),
                 "l"(src + 4 * v));
}

__device__ inline void commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int kPending>
__device__ inline void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Starts copying n floats of one image into shared memory and commits one
// group: asynchronous copies where the source allows them, else plain loads.
__device__ inline void stage_image(const float* __restrict__ src, float* dst, int n) {
  if ((n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0)
    copy_async(src, dst, n, threadIdx.x, blockDim.x);
  else
    for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
  commit();
}

// Taps of n coordinates on an axis of length len; offsets scaled by stride.
// The same fp32 operations as _interp_matrix.
__device__ __forceinline__ void make_taps(const float* __restrict__ coords, int n, int len,
                                          int stride, Tap* taps) {
  const float hi = (float)(len - 1);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    const float u = coords[e];
    const float x0 = floorf(u);
    const float i0 = fminf(fmaxf(x0, 0.f), hi);
    const float i1 = fminf(fmaxf(x0 + 1.f, 0.f), hi);
    Tap t;
    t.o0 = (int)i0 * stride;
    t.o1 = (int)i1 * stride;
    const bool apart = i0 != i1;
    t.w0 = apart ? i1 - u : 0.f;
    t.w1 = apart ? u - i0 : 0.f;
    taps[e] = t;
  }
}

// The work of one warp at a time: kRows consecutive output rows p0 ... of
// cell kk of the block (fewer at the end of a cell), contiguous in the
// output and in g.
struct Group {
  int kk, p0, n;
};

__device__ inline Group group_of(int gi, int per_cell, int ho) {
  Group g;
  g.kk = gi / per_cell;
  g.p0 = (gi - g.kk * per_cell) * kRows;
  g.n = min(kRows, ho - g.p0);
  return g;
}

// Starts copying group gi's rows of g into a warp's buffer and commits one
// group, also where there is no such row, so that the groups a lane waits
// on count row groups. Rows that are not 16-byte aligned are copied at once.
__device__ inline void start_group(const float* __restrict__ g0, int gi, int n_groups,
                                   int per_cell, const Shapes& s, int oc, float* dst, bool vec,
                                   int lane) {
  if (gi < n_groups) {
    const Group gr = group_of(gi, per_cell, s.ho);
    const float* src = g0 + (size_t)(gr.kk * s.ho + gr.p0) * oc;
    if (vec)
      copy_async(src, dst, gr.n * oc, lane, 32);
    else
      for (int e = lane; e < gr.n * oc; e += 32) dst[e] = src[e];
  }
  commit();
}

// Sums v[r] over the warp for each of R rows (R a power of two, at most
// 32) in log2(R) + log2(32/R) shuffles: at each of the first log2(R) steps
// a lane keeps the half of the rows its lane bit selects and adds its
// partner's copy of that half. Lane i ends with the sum of row i / (32/R).
// The order of the sums is fixed.
template <int R>
__device__ __forceinline__ float warp_row_sums(float (&v)[R], int lane) {
#pragma unroll
  for (int n = R, off = 16; n > 1; n >>= 1, off >>= 1) {
    const bool upper = (lane & off) != 0;
#pragma unroll
    for (int r = 0; r < n / 2; ++r) {
      const float keep = upper ? v[r + n / 2] : v[r];
      const float send = upper ? v[r] : v[r + n / 2];
      v[r] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  float x = v[0];
#pragma unroll
  for (int off = 16 / R; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// A warp takes row groups of the block's cells, groups warp, warp + kWarps,
// ...; lane q (and q + 32, ... up to kSlots) takes column q and keeps its
// column taps in registers while the cell lasts.
template <int kSlots, int kC>
__global__ void __launch_bounds__(kThreads)
    crop_fwd_kernel(const float* __restrict__ img, const float* __restrict__ ys,
                    const float* __restrict__ xs, float* __restrict__ out, Shapes s, int cpb) {
  extern __shared__ __align__(16) float smem[];
  const Layout l = make_layout(s, cpb, false, false);
  const int blocks_per_image = (s.K + cpb - 1) / cpb;
  const int b = blockIdx.x / blocks_per_image, k0 = (blockIdx.x % blocks_per_image) * cpb;
  const int nk = min(cpb, s.K - k0);
  const int C = kC ? kC : s.C;
  const int n_img = s.H * s.W * C, oc = s.wo * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Tap* rows = reinterpret_cast<Tap*>(smem + l.rows);
  Tap* cols = reinterpret_cast<Tap*>(smem + l.cols);
  float* stage = smem + l.stage + warp * l.ld_stage;
  stage_image(img + (size_t)b * n_img, smem, n_img);
  const size_t cell0 = (size_t)b * s.K + k0;
  make_taps(ys + cell0 * s.ho, nk * s.ho, s.H, s.W * C, rows);
  make_taps(xs + cell0 * s.wo, nk * s.wo, s.W, C, cols);
  wait_groups<0>();
  __syncthreads();
  // Every row group starts 16-byte aligned where wo*C is a multiple of 4.
  const bool vec = (oc & 3) == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int per_cell = (s.ho + kRows - 1) / kRows;
  float* out0 = out + cell0 * s.ho * oc;
  Tap tx[kSlots];
  int cur = -1;
  for (int gi = warp; gi < nk * per_cell; gi += kWarps) {
    const Group gr = group_of(gi, per_cell, s.ho);
    if (gr.kk != cur) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j)
        if (lane + 32 * j < s.wo) tx[j] = cols[gr.kk * s.wo + lane + 32 * j];
      cur = gr.kk;
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i < gr.n) {
        const Tap ty = rows[gr.kk * s.ho + gr.p0 + i];
        const float* r0 = smem + ty.o0;
        const float* r1 = smem + ty.o1;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int q = lane + 32 * j;
          if (q < s.wo) {
            // The dense products' roundings: rows first, the i0 product and
            // an FMA of the i1 one onto it, then columns the same way.
            const Tap t = tx[j];
            const float *a = r0 + t.o0, *bb = r0 + t.o1, *cc = r1 + t.o0, *d = r1 + t.o1;
            float* o = stage + i * oc + q * C;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              const float left = fmaf(ty.w1, cc[c], ty.w0 * a[c]);
              const float right = fmaf(ty.w1, d[c], ty.w0 * bb[c]);
              o[c] = fmaf(t.w1, right, t.w0 * left);
            }
          }
        }
      }
    }
    __syncwarp();
    float* dst = out0 + (size_t)(gr.kk * s.ho + gr.p0) * oc;
    if (vec)
      for (int v = lane; v < gr.n * oc / 4; v += 32)
        reinterpret_cast<float4*>(dst)[v] = reinterpret_cast<const float4*>(stage)[v];
    else
      for (int e = lane; e < gr.n * oc; e += 32) dst[e] = stage[e];
    __syncwarp();  // the buffer is the next group's
  }
}

// Adds one cell's g_img into gimg: t = the column scatter of g, then the
// row scatter of t. Each entry of t and of gimg has one owning thread.
__device__ __forceinline__ void cell_image_grad(const Tap* ty, const Tap* tx, const float* __restrict__ gc,
                                float* t, float* gimg, const Shapes& s) {
  const int WC = s.W * s.C, oc = s.wo * s.C;
  for (int e = threadIdx.x; e < s.ho * WC; e += blockDim.x) t[e] = 0.f;
  __syncthreads();
  for (int e = threadIdx.x; e < s.ho * s.C; e += blockDim.x) {
    const int p = e / s.C, c = e - p * s.C;
    float* row = t + p * WC + c;
    const float* g_row = gc + p * oc + c;
    for (int q = 0; q < s.wo; ++q) {
      const Tap cl = tx[q];
      const float gv = g_row[q * s.C];
      row[cl.o0] += cl.w0 * gv;
      row[cl.o1] += cl.w1 * gv;
    }
  }
  __syncthreads();
  for (int col = threadIdx.x; col < WC; col += blockDim.x) {
    for (int p = 0; p < s.ho; ++p) {
      const Tap r = ty[p];
      const float tv = t[p * WC + col];
      gimg[r.o0 + col] += r.w0 * tv;
      gimg[r.o1 + col] += r.w1 * tv;
    }
  }
}

// Row groups and columns are dealt as in the forward. A warp reads the
// groups of g through its ring of kStages buffers (16 bytes a lane),
// kStages - 1 groups ahead, sums a group's g_ys with warp_row_sums, and keeps
// each lane's g_xs partial in a register while the cell lasts; the warps'
// column partials then add in warp order. With g_img the block holds all K
// cells of an image and adds their scatters in order.
template <int kSlots, int kC>
__global__ void __launch_bounds__(kThreads)
    crop_bwd_kernel(const float* __restrict__ img, const float* __restrict__ ys,
                    const float* __restrict__ xs, const float* __restrict__ g,
                    float* __restrict__ g_img, float* __restrict__ g_ys,
                    float* __restrict__ g_xs, Shapes s, int cpb) {
  extern __shared__ __align__(16) float smem[];
  const bool with_gimg = g_img != nullptr;
  const Layout l = make_layout(s, cpb, true, with_gimg);
  const int blocks_per_image = (s.K + cpb - 1) / cpb;
  const int b = blockIdx.x / blocks_per_image, k0 = (blockIdx.x % blocks_per_image) * cpb;
  const int nk = min(cpb, s.K - k0);
  const int C = kC ? kC : s.C;
  const int n_img = s.H * s.W * C, oc = s.wo * C;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Tap* rows = reinterpret_cast<Tap*>(smem + l.rows);
  Tap* cols = reinterpret_cast<Tap*>(smem + l.cols);
  float* ring = smem + l.stage + warp * kStages * l.ld_stage;
  float* colpart = smem + l.colpart;
  float* gimg = smem + l.gimg;
  const size_t cell0 = (size_t)b * s.K + k0;
  const bool vec = (oc & 3) == 0 && (reinterpret_cast<uintptr_t>(g) & 15) == 0;
  const int per_cell = (s.ho + kRows - 1) / kRows, n_groups = nk * per_cell;
  const float* g0 = g + cell0 * s.ho * oc;  // the block's rows of g, one after the other
  stage_image(img + (size_t)b * n_img, smem, n_img);
  // The first groups of g are asked for with the image.
  for (int i = 0; i < kStages - 1; ++i)
    start_group(g0, warp + i * kWarps, n_groups, per_cell, s, oc, ring + i * l.ld_stage, vec,
                lane);
  make_taps(ys + cell0 * s.ho, nk * s.ho, s.H, s.W * C, rows);
  make_taps(xs + cell0 * s.wo, nk * s.wo, s.W, C, cols);
  for (int e = threadIdx.x; e < nk * kWarps * s.wo; e += blockDim.x) colpart[e] = 0.f;
  if (with_gimg)
    for (int e = threadIdx.x; e < n_img; e += blockDim.x) gimg[e] = 0.f;
  wait_groups<kStages - 1>();  // the image's group is the oldest
  __syncthreads();
  Tap tx[kSlots];
  float gx[kSlots];
  int cur = -1;
  for (int gi = warp, it = 0; gi < n_groups; gi += kWarps, ++it) {
    start_group(g0, gi + (kStages - 1) * kWarps, n_groups, per_cell, s, oc,
                ring + ((it + kStages - 1) % kStages) * l.ld_stage, vec, lane);
    const Group gr = group_of(gi, per_cell, s.ho);
    if (gr.kk != cur) {
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int q = lane + 32 * j;
        if (cur >= 0 && q < s.wo) colpart[(cur * kWarps + warp) * s.wo + q] = gx[j];
        if (q < s.wo) tx[j] = cols[gr.kk * s.wo + q];
        gx[j] = 0.f;
      }
      cur = gr.kk;
    }
    wait_groups<kStages - 1>();  // this group's rows have landed
    __syncwarp();
    const float* stage = ring + (it % kStages) * l.ld_stage;
    float gy[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      gy[i] = 0.f;
      if (i < gr.n) {
        const Tap ty = rows[gr.kk * s.ho + gr.p0 + i];
        const float* r0 = smem + ty.o0;
        const float* r1 = smem + ty.o1;
#pragma unroll
        for (int j = 0; j < kSlots; ++j) {
          const int q = lane + 32 * j;
          if (q < s.wo) {
            // The four taps against g, summed over the channels first.
            const Tap t = tx[j];
            const float *a = r0 + t.o0, *bb = r0 + t.o1, *cc = r1 + t.o0, *d = r1 + t.o1;
            const float* gq = stage + i * oc + q * C;
            float ga = 0.f, gb = 0.f, gc = 0.f, gd = 0.f;
#pragma unroll
            for (int c = 0; c < C; ++c) {
              ga += gq[c] * a[c];
              gb += gq[c] * bb[c];
              gc += gq[c] * cc[c];
              gd += gq[c] * d[c];
            }
            gy[i] += t.w0 * (gc - ga) + t.w1 * (gd - gb);
            gx[j] += ty.w0 * (gb - ga) + ty.w1 * (gd - gc);
          }
        }
      }
    }
    const float sum = warp_row_sums<kRows>(gy, lane);
    const int row = lane / (32 / kRows);
    if (lane % (32 / kRows) == 0 && row < gr.n)
      g_ys[(cell0 + gr.kk) * s.ho + gr.p0 + row] = sum;
    __syncwarp();  // the buffer is refilled next group
  }
  if (cur >= 0) {
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const int q = lane + 32 * j;
      if (q < s.wo) colpart[(cur * kWarps + warp) * s.wo + q] = gx[j];
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < nk * s.wo; e += blockDim.x) {
    const int kk = e / s.wo, q = e - kk * s.wo;
    float sum = 0.f;
    for (int w = 0; w < kWarps; ++w) sum += colpart[(kk * kWarps + w) * s.wo + q];
    g_xs[cell0 * s.wo + e] = sum;
  }
  if (with_gimg) {
    const int n_cell = s.ho * oc;
    for (int kk = 0; kk < nk; ++kk) {
      cell_image_grad(rows + kk * s.ho, cols + kk * s.wo, g + (cell0 + kk) * n_cell,
                      smem + l.t, gimg, s);
      __syncthreads();  // t is the next cell's
    }
    float* o = g_img + (size_t)b * n_img;
    for (int e = threadIdx.x; e < n_img; e += blockDim.x) o[e] = gimg[e];
  }
}

cudaError_t prepare(const void* kernel, size_t smem) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// The instance for the column slots wo needs (1, 2 or 4) and for C: 3
// channels unrolled, any other count in a loop (kC = 0).
template <template <int, int> class K>
const void* pick(int slots, int C) {
  if (C == 3) return slots <= 1 ? K<1, 3>::fn() : slots <= 2 ? K<2, 3>::fn() : K<4, 3>::fn();
  return slots <= 1 ? K<1, 0>::fn() : slots <= 2 ? K<2, 0>::fn() : K<4, 0>::fn();
}

template <template <int, int> class K, typename... Args>
cudaError_t launch(const Shapes& s, int blocks, size_t smem, cudaStream_t stream, Args... args) {
  const int slots = (s.wo + 31) / 32;
  if (slots > 4) return cudaErrorInvalidValue;
  const void* fn = pick<K>(slots, s.C);
  cudaError_t err = prepare(fn, smem);
  if (err != cudaSuccess) return err;
  void* params[] = {&args...};
  err = cudaLaunchKernel(fn, dim3(blocks), dim3(kThreads), params, smem, stream);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kSlots, int kC>
struct FwdKernel {
  static const void* fn() { return (const void*)crop_fwd_kernel<kSlots, kC>; }
};

template <int kSlots, int kC>
struct BwdKernel {
  static const void* fn() { return (const void*)crop_bwd_kernel<kSlots, kC>; }
};

}  // namespace

extern "C" {

const char* crop_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// img [B,H,W,C], ys [B,K,ho], xs [B,K,wo] -> out [B,K,ho,wo,C], cpb cells a
// block; wo at most 128. Returns the launch's cudaError_t.
int crop_fwd(const float* img, const float* ys, const float* xs, float* out, int B, int K, int H,
             int W, int ho, int wo, int C, int cpb, void* stream) {
  const Shapes s{K, H, W, ho, wo, C};
  const size_t smem = sizeof(float) * make_layout(s, cpb, false, false).total;
  const int groups = (K + cpb - 1) / cpb;
  return (int)launch<FwdKernel>(s, B * groups, smem, (cudaStream_t)stream, img, ys, xs, out, s,
                                cpb);
}

// g [B,K,ho,wo,C] -> g_img [B,H,W,C] (may be null), g_ys [B,K,ho],
// g_xs [B,K,wo]. Without g_img the cells go cpb a block; with it one block
// an image walks all K cells.
int crop_bwd(const float* img, const float* ys, const float* xs, const float* g, float* g_img,
             float* g_ys, float* g_xs, int B, int K, int H, int W, int ho, int wo, int C, int cpb,
             void* stream) {
  const Shapes s{K, H, W, ho, wo, C};
  if (g_img != nullptr) cpb = K;
  const size_t smem = sizeof(float) * make_layout(s, cpb, true, g_img != nullptr).total;
  const int groups = (K + cpb - 1) / cpb;
  return (int)launch<BwdKernel>(s, B * groups, smem, (cudaStream_t)stream, img, ys, xs, g, g_img,
                                g_ys, g_xs, s, cpb);
}

}  // extern "C"
