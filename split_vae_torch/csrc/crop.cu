// STN glimpse crop for SPAIR, forward and backward.
//
// Replaces the Pallas TPU kernel pairs tools/pallas_research/crop_fused.py
// (_fwd_kernel:33, _bwd_kernel:42) and tools/pallas_research/crop_packed.py
// (_fwd_kernel:64, _bwd_kernel:80). The two differ only in the TPU's 8-row
// sublane packing, which means nothing here: one pair takes any H, W, ho, wo,
// C and K and masks its ragged edges.
//
// Per image b and cell k (layouts as the JAX package's, channel last):
//   out[b,k,p,q,c] = sum_{i,j} wy[b,k,p,i] * img[b,i,j,c] * wx[b,k,q,j]
// and, for a cotangent g shaped as out, three product families:
//   g_img[b]   = sum_k wy^T . (g . wx)        t = g . wx        [ho, W*C]
//   g_wy[b,k]  = t . img^T  (over j and c)
//   g_wx[b,k]  = sum_c g_c^T . (wy . img_c)
//
// What bounds it on an H100 SXM (B=256, K=16, 48 -> 32 px, C=3, fp32): the
// forward moves 107.7 MB (img 7.1, wy and wx 25.2 each, out 50.3), 32 us at
// 3.35 TB/s, and does 3.02 GFLOP of dense products, 45 us at 67 TFLOP/s fp32
// without tensor cores: bound by operations. The backward moves 165.2 MB
// (49 us) and does five products a cell (t, g_img, g_wy, wy.img, g_wx),
// 7.85 GFLOP, 117 us: bound by operations.
//
// Design. The image is kept in shared memory as it lies in device memory,
// [H][W*C], so (j, c) is one long column index: wy . img is a single
// [ho, H] x [H, W*C] product and g_wy a single product over W*C. Only the
// products with wx run per channel, on columns strided by C. A block stages
// one image once and loops over some of its cells:
//   - forward: kCellsPerBlock cells a block, B*K/kCellsPerBlock blocks, since
//     one block an image (the TPU grid) would be under two waves on 132 SMs;
//   - backward with g_img: one block an image over all K cells, g_img summed
//     in shared memory in cell order, so the result is deterministic and
//     needs no atomics; without g_img (on the model's path the image is the
//     input batch) the cells are split over blocks as in the forward.
// All arithmetic is plain fp32 FMA from shared memory through tile_gemm.cuh;
// shared rows have odd lengths so a warp's loads spread over the banks. The
// rows of wy and wx hold two non-zeros each (bilinear weights): this first
// kernel computes the dense products as the TPU kernels do; using the band
// is open to a later revision.
//
// Built with nvcc for sm_90a into a shared library with a plain C interface
// (split_vae_torch/kernels/crop.py loads it with ctypes).

#include <cuda_runtime.h>

#include "tile_gemm.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCellsPerBlock = 2;

struct Shapes {
  int K, H, W, ho, wo, C;
};

__host__ __device__ inline int odd(int n) { return n | 1; }

// Shared-memory layout, in floats: img [H][ldi] at 0, then wy [ho][ldy],
// wx [wo][ldx], tmp [ho][ldt], g or out [ho][ldg] and, for a backward that
// gives g_img, its sum [H][ldi].
struct Layout {
  int ldi, ldy, ldx, ldt, ldg;
  int wy, wx, tmp, g, gimg, total;
};

__host__ __device__ inline Layout make_layout(const Shapes& s, bool with_gimg) {
  Layout l;
  l.ldi = odd(s.W * s.C);
  l.ldy = odd(s.H);
  l.ldx = odd(s.W);
  l.ldt = odd(s.W * s.C);
  l.ldg = odd(s.wo * s.C);
  l.wy = s.H * l.ldi;
  l.wx = l.wy + s.ho * l.ldy;
  l.tmp = l.wx + s.wo * l.ldx;
  l.g = l.tmp + s.ho * l.ldt;
  l.gimg = l.g + s.ho * l.ldg;
  l.total = l.gimg + (with_gimg ? s.H * l.ldi : 0);
  return l;
}

// Copies a dense [rows][cols] array into shared rows of length ld.
__device__ void stage_rows(const float* __restrict__ src, int rows, int cols, float* dst, int ld) {
  for (int e = threadIdx.x; e < rows * cols; e += blockDim.x)
    dst[(e / cols) * ld + e % cols] = src[e];
}

// tmp[p][(j,c)] = sum_i wy[p][i] * img[i][(j,c)]
__device__ void wy_img(const Shapes& s, const Layout& l, float* smem) {
  gemm<2, 9>(smem + l.wy, 0, l.ldy, 1, smem, 0, 1, l.ldi, smem + l.tmp, l.ldt, 1, s.ho,
             s.W * s.C, s.H);
}

__global__ void __launch_bounds__(kThreads, 2)
    crop_fwd_kernel(const float* __restrict__ img, const float* __restrict__ wy,
                    const float* __restrict__ wx, float* __restrict__ out, Shapes s, int cpb) {
  extern __shared__ float smem[];
  const Layout l = make_layout(s, false);
  const int groups = (s.K + cpb - 1) / cpb;
  const int b = blockIdx.x / groups, k0 = (blockIdx.x % groups) * cpb;
  const int k1 = min(k0 + cpb, s.K);
  const int WC = s.W * s.C, oc = s.wo * s.C;
  stage_rows(img + (size_t)b * s.H * WC, s.H, WC, smem, l.ldi);
  for (int k = k0; k < k1; ++k) {
    const size_t cell = (size_t)b * s.K + k;
    stage_rows(wy + cell * s.ho * s.H, s.ho, s.H, smem + l.wy, l.ldy);
    stage_rows(wx + cell * s.wo * s.W, s.wo, s.W, smem + l.wx, l.ldx);
    __syncthreads();
    wy_img(s, l, smem);
    __syncthreads();
    // out[p][(q,c)] = sum_j tmp[p][(j,c)] * wx[q][j], a product a channel.
    for (int c = 0; c < s.C; ++c)
      gemm<2, 2>(smem + l.tmp + c, 0, l.ldt, s.C, smem + l.wx, 0, l.ldx, 1, smem + l.g + c, l.ldg,
                 s.C, s.ho, s.wo, s.W);
    __syncthreads();
    float* o = out + cell * s.ho * oc;
    for (int e = threadIdx.x; e < s.ho * oc; e += blockDim.x)
      o[e] = smem[l.g + (e / oc) * l.ldg + e % oc];
    // The next cell writes wy and wx first, then tmp and out each after a
    // barrier of its own, so none is needed here.
  }
}

__global__ void __launch_bounds__(kThreads, 2)
    crop_bwd_kernel(const float* __restrict__ img, const float* __restrict__ wy,
                    const float* __restrict__ wx, const float* __restrict__ g,
                    float* __restrict__ g_img, float* __restrict__ g_wy,
                    float* __restrict__ g_wx, Shapes s, int cpb) {
  extern __shared__ float smem[];
  const bool with_gimg = g_img != nullptr;
  const Layout l = make_layout(s, with_gimg);
  const int groups = (s.K + cpb - 1) / cpb;
  const int b = blockIdx.x / groups, k0 = (blockIdx.x % groups) * cpb;
  const int k1 = min(k0 + cpb, s.K);
  const int WC = s.W * s.C, oc = s.wo * s.C;
  float* s_img = smem;
  float* s_wy = smem + l.wy;
  float* s_wx = smem + l.wx;
  float* s_t = smem + l.tmp;
  float* s_g = smem + l.g;
  float* s_gimg = smem + l.gimg;
  stage_rows(img + (size_t)b * s.H * WC, s.H, WC, s_img, l.ldi);
  if (with_gimg)
    for (int e = threadIdx.x; e < s.H * l.ldi; e += blockDim.x) s_gimg[e] = 0.f;
  for (int k = k0; k < k1; ++k) {
    const size_t cell = (size_t)b * s.K + k;
    stage_rows(wy + cell * s.ho * s.H, s.ho, s.H, s_wy, l.ldy);
    stage_rows(wx + cell * s.wo * s.W, s.wo, s.W, s_wx, l.ldx);
    stage_rows(g + cell * s.ho * oc, s.ho, oc, s_g, l.ldg);
    __syncthreads();
    // t[p][(j,c)] = sum_q g[p][(q,c)] * wx[q][j], a product a channel.
    for (int c = 0; c < s.C; ++c)
      gemm<2, 3>(s_g + c, 0, l.ldg, s.C, s_wx, 0, 1, l.ldx, s_t + c, l.ldt, s.C, s.ho, s.W, s.wo);
    __syncthreads();
    // g_img[i][(j,c)] += sum_p wy[p][i] * t[p][(j,c)]: every entry has one
    // owning thread, and the cells come in order.
    if (with_gimg)
      gemm<3, 9, true>(s_wy, 0, 1, l.ldy, s_t, 0, 1, l.ldt, s_gimg, l.ldi, 1, s.H, WC, s.ho);
    // g_wy[p][i] = sum_(j,c) t[p][(j,c)] * img[i][(j,c)]
    gemm<2, 3>(s_t, 0, l.ldt, 1, s_img, 0, l.ldi, 1, g_wy + cell * s.ho * s.H, s.H, 1, s.ho, s.H,
               WC);
    __syncthreads();
    wy_img(s, l, smem);  // over t, which is used up
    __syncthreads();
    // g_wx[q][j] = sum_c sum_p g[p][(q,c)] * tmp[p][(j,c)]
    gemm<2, 3>(s_g, 1, s.C, l.ldg, s_t, 1, s.C, l.ldt, g_wx + cell * s.wo * s.W, s.W, 1, s.wo, s.W,
               s.ho, s.C);
    __syncthreads();
  }
  if (with_gimg) {
    float* o = g_img + (size_t)b * s.H * WC;
    for (int e = threadIdx.x; e < s.H * WC; e += blockDim.x)
      o[e] = s_gimg[(e / WC) * l.ldi + e % WC];
  }
}

}  // namespace

extern "C" {

const char* crop_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// img [B,H,W,C], wy [B,K,ho,H], wx [B,K,wo,W] -> out [B,K,ho,wo,C].
// Returns the launch's cudaError_t.
int crop_fwd(const float* img, const float* wy, const float* wx, float* out, int B, int K, int H,
             int W, int ho, int wo, int C, void* stream) {
  const Shapes s{K, H, W, ho, wo, C};
  const size_t smem = sizeof(float) * make_layout(s, false).total;
  cudaError_t err = cudaFuncSetAttribute(crop_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (K + kCellsPerBlock - 1) / kCellsPerBlock;
  crop_fwd_kernel<<<B * groups, kThreads, smem, (cudaStream_t)stream>>>(img, wy, wx, out, s,
                                                                         kCellsPerBlock);
  return (int)cudaGetLastError();
}

// g [B,K,ho,wo,C] -> g_img, g_wy, g_wx shaped as their inputs. g_img may be
// null when the image needs no gradient; the cells of an image are then
// split over blocks.
int crop_bwd(const float* img, const float* wy, const float* wx, const float* g, float* g_img,
             float* g_wy, float* g_wx, int B, int K, int H, int W, int ho, int wo, int C,
             void* stream) {
  const Shapes s{K, H, W, ho, wo, C};
  const bool with_gimg = g_img != nullptr;
  const size_t smem = sizeof(float) * make_layout(s, with_gimg).total;
  cudaError_t err = cudaFuncSetAttribute(crop_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int cpb = with_gimg ? K : kCellsPerBlock;
  const int groups = (K + cpb - 1) / cpb;
  crop_bwd_kernel<<<B * groups, kThreads, smem, (cudaStream_t)stream>>>(img, wy, wx, g, g_img,
                                                                         g_wy, g_wx, s, cpb);
  return (int)cudaGetLastError();
}

}  // extern "C"
