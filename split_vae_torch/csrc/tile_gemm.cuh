// A small block-wide matrix product over shared (or global) memory, shared by
// the render and crop kernels.
//
// Shared-memory bank conflicts are the first limit of such small products: a
// thread's rows and columns are strided (m = tm + i*MT, n = tn + j*NT), so the
// 32 threads of a warp touch neighbouring columns, and callers give their
// shared arrays odd row lengths.

#pragma once

// One thread's TM x TN entries of C (rows tm + i*MT, columns tn + j*NT):
// C[m, n] (+)= sum_c sum_k A[c*as + m*am + k*ak] * B[c*bs + n*bn + k*bk].
template <int TM, int TN, bool ACC>
__device__ __forceinline__ void gemm_tile(int tm, int tn, int MT, int NT, const float* A, int as,
                                          int am, int ak, const float* B, int bs, int bn, int bk,
                                          float* Cp, int cm, int cn, int M, int N, int K, int nc) {
  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  for (int c = 0; c < nc; ++c) {
    const float* Ac = A + c * as;
    const float* Bc = B + c * bs;
    for (int k = 0; k < K; ++k) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        const int m = tm + i * MT;
        a[i] = (m < M) ? Ac[m * am + k * ak] : 0.f;
      }
#pragma unroll
      for (int j = 0; j < TN; ++j) {
        const int n = tn + j * NT;
        bv[j] = (n < N) ? Bc[n * bn + k * bk] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int m = tm + i * MT, n = tn + j * NT;
      if (m < M && n < N) {
        if (ACC)
          Cp[m * cm + n * cn] += acc[i][j];
        else
          Cp[m * cm + n * cn] = acc[i][j];
      }
    }
}

// C[m, n] (+)= sum_c sum_k A[c*as + m*am + k*ak] * B[c*bs + n*bn + k*bk] for
// an M x N x K product over nc channels. Each thread computes TM x TN entries,
// rows tm + i*MT and columns tn + j*NT, so neighbouring threads touch
// neighbouring columns. C may be shared or global memory; with ACC the
// product is added to what C holds (each entry has one owner, so there is no
// race within a call).
template <int TM, int TN, bool ACC = false>
__device__ void gemm(const float* A, int as, int am, int ak, const float* B, int bs, int bn,
                     int bk, float* Cp, int cm, int cn, int M, int N, int K, int nc = 1) {
  const int MT = (M + TM - 1) / TM, NT = (N + TN - 1) / TN;
  for (int t = threadIdx.x; t < MT * NT; t += blockDim.x)
    gemm_tile<TM, TN, ACC>(t / NT, t % NT, MT, NT, A, as, am, ak, B, bs, bn, bk, Cp, cm, cn, M, N,
                           K, nc);
}

// nb independent M x N x K products in one pass over the block's threads:
// C_b[m, n] = sum_k A[b*ab + m*am + k*ak] * B[b*bb + n*bn + k*bk], written to
// C[b*cb + m*cm + n*cn]. A stride of 0 shares an operand between the products.
template <int TM, int TN>
__device__ void gemm_batch(const float* A, int ab, int am, int ak, const float* B, int bb, int bn,
                           int bk, float* Cp, int cb, int cm, int cn, int M, int N, int K,
                           int nb) {
  const int MT = (M + TM - 1) / TM, NT = (N + TN - 1) / TN, per = MT * NT;
  for (int t = threadIdx.x; t < nb * per; t += blockDim.x) {
    const int b = t / per, r = t % per;
    gemm_tile<TM, TN, false>(r / NT, r % NT, MT, NT, A + b * ab, 0, am, ak, B + b * bb, 0, bn, bk,
                             Cp + b * cb, cm, cn, M, N, K, 1);
  }
}
