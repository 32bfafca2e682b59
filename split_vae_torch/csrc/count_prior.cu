// The SPAIR z_pres count-prior KL, forward and backward, as two kernels.
//
// It replaces no TPU kernel: the JAX package writes the recurrence as a
// lax.scan (split_vae_tpu/ops/count_prior.py), which XLA compiles into one
// loop. The port's loop (ops/count_prior.py::count_kl_loop) is ~20 ATen ops
// a cell in each direction, each on [B, K+1] or [B, 1]: ~1,400 launches a
// train step at B=256, K=16, each microseconds of work.
//
// The function (spair/trainer.py:45-94), per image b, cells i in row-major
// order, prior success probability p, temperature tau:
//   c = 1 - p;  dist[j] = (1 - c) c^j, j = 0..K;  d = dist / max(sum dist, 1e-6)
//   n = 0 (objects so far)
//   for i in 0..K-1:
//     q[j]  = max(j - n, 0) * (1 / (K - i))
//     p_z   = sum_j d[j] q[j]
//     lo_p  = safe_log(p_z) - safe_log(1 - p_z)   (safe_log: log(x + 1e-8), -100 if not finite)
//     kl_i  = log_q(y) - log_p(y), y = pre[b,i], with
//             log_(lo)(y) = log(tau + 1e-8) - y tau + lo - 2 log(1 + exp(-y tau + lo) + 1e-8),
//             lo = logits[b,i] for q, lo_p for p
//     s     = pres[b,i] > 0.5
//     d[j]  = (s ? q[j] : 1 - q[j]) d[j];  d = d / max(sum d, 1e-6);  n += s
//   totals[b] = sum_i kl_i (in order i = 0, 1, ...)
// Every operation is the loop's, rounded on its own (__fmul_rn, __fadd_rn,
// __fdiv_rn: nothing is contracted into an FMA); a division by the Python
// number K - i is a multiply by its float32 reciprocal, as ATen does it on
// the card. Only the sums over j take another order: ATen's reduction there,
// a warp tree here.
//
// Gradients. z_pres enters only through s, p is an anneal, so d, p_z and lo_p
// carry none: the gradient flows into pre and logits through the cell's KL
// alone, elementwise. With g = g_totals[b] and e_x = exp(-y tau + lo_x),
// s2_x = (e_x + 1) + 1e-8, the backward takes autograd's expression order
// through ops/distributions.py::concrete_binary_sample_kl:
//   m_q = ((-g) 2 / s2_q) e_q,   m_p = (g 2 / s2_p) e_p
//   g_logits = g + m_q
//   g_pre    = (g + (-m_p)) tau + ((-g) + (-m_q)) tau
// so the extremes read as the loop's: exp overflowing to inf gives
// 2g / inf = 0 and 0 * inf = NaN where the loop's autograd gives NaN, and the
// optimizer's non-finite skip sees the same step.
//
// Bound (H100 SXM, 3.35 TB/s; B=256, K=16): latency. The forward reads
// 3 B K floats and writes B (K + 1): 66 KB, 20 ns of bandwidth; its work is a
// chain of K steps a warp, each two warp sums, two logs, two exps and a log.
// The backward moves 6 B K floats. Both are a launch's floor on the card.
//
// Design. Forward: one warp an image, kWarps images a block; a lane holds the
// count distribution's entries j = lane, lane + 32, ... in its warp's slice of
// shared memory (only that lane reads and writes them, so no barrier), and
// each of the warp's lanes computes the cell's KL alike after the sums, which
// a shuffle butterfly leaves equal in every lane. Lane 0 writes the cell's
// prior log-odds, which the backward reads, and the image's total. The sums
// are in a fixed order, without atomics: two runs are bit-equal. p is read
// from the device where the caller hands a pointer (the train step's anneal,
// a device tensor that a CUDA graph's replay recomputes), else taken by
// value. Backward: one thread a (b, i).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kWarps = 4;           // images a block in the forward
constexpr int kBwdThreads = 256;
constexpr int kSmemBytes = 48 * 1024;
constexpr int kMaxCells = kSmemBytes / (4 * kWarps) - 1;  // kWarps slices of K + 1 floats
constexpr float kEps = 1e-8f;       // safe_log's and the KL's
constexpr float kFloor = 1e-6f;     // the normalizers' clamp_min

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// torch.clamp_min: a NaN stays NaN.
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }

__device__ __forceinline__ float safe_log(float x) {
  const float l = logf(__fadd_rn(x, kEps));
  return isfinite(l) ? l : -100.0f;
}

// log(tau + 1e-8) - y tau + lo - 2 log(1 + exp(-y tau + lo) + 1e-8), as the
// loop's ops compute it (yt = y tau).
__device__ __forceinline__ float log_density(float yt, float lo, float log_tau) {
  const float e = expf(__fadd_rn(-yt, lo));
  const float l = logf(__fadd_rn(__fadd_rn(e, 1.0f), kEps));
  return __fsub_rn(__fadd_rn(__fsub_rn(log_tau, yt), lo), __fmul_rn(2.0f, l));
}

// q[j] = max(j - n, 0) * inv, and the product's j.
__device__ __forceinline__ float given(int j, float n, float inv) {
  return __fmul_rn(fmaxf(__fsub_rn((float)j, n), 0.0f), inv);
}

__global__ void __launch_bounds__(kWarps * 32)
    count_prior_fwd_kernel(const float* __restrict__ pres, const float* __restrict__ logits,
                           const float* __restrict__ pre, const float* __restrict__ prior,
                           float prior_value, float tau, float log_tau, int B, int K,
                           float* __restrict__ totals, float* __restrict__ log_odds) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  if (b >= B) return;  // the whole warp leaves: no shuffle waits on it
  float* d = smem + warp * (K + 1);
  const float c = __fsub_rn(1.0f, prior != nullptr ? *prior : prior_value);
  const float q0 = __fsub_rn(1.0f, c);
  float part = 0.0f;
  for (int j = lane; j <= K; j += 32) {
    const float v = __fmul_rn(q0, powf(c, (float)j));
    d[j] = v;
    part = __fadd_rn(part, v);
  }
  float norm = clamp_min(warp_sum(part), kFloor);
  for (int j = lane; j <= K; j += 32) d[j] = __fdiv_rn(d[j], norm);

  const size_t row = (size_t)b * K;
  float n = 0.0f, total = 0.0f;
  for (int i = 0; i < K; ++i) {
    const float inv = __fdiv_rn(1.0f, (float)(K - i));
    part = 0.0f;
    for (int j = lane; j <= K; j += 32) part = __fadd_rn(part, __fmul_rn(d[j], given(j, n, inv)));
    const float p_z = warp_sum(part);
    const float lo_p = __fsub_rn(safe_log(p_z), safe_log(__fsub_rn(1.0f, p_z)));
    const float yt = __fmul_rn(pre[row + i], tau);
    const float kl = __fsub_rn(log_density(yt, logits[row + i], log_tau),
                               log_density(yt, lo_p, log_tau));
    const bool s = pres[row + i] > 0.5f;
    part = 0.0f;
    for (int j = lane; j <= K; j += 32) {
      const float q = given(j, n, inv);
      const float v = __fmul_rn(s ? q : __fsub_rn(1.0f, q), d[j]);
      d[j] = v;
      part = __fadd_rn(part, v);
    }
    norm = clamp_min(warp_sum(part), kFloor);
    for (int j = lane; j <= K; j += 32) d[j] = __fdiv_rn(d[j], norm);
    n = __fadd_rn(n, s ? 1.0f : 0.0f);
    total = __fadd_rn(total, kl);
    if (lane == 0) log_odds[row + i] = lo_p;
  }
  if (lane == 0) totals[b] = total;
}

__global__ void __launch_bounds__(kBwdThreads)
    count_prior_bwd_kernel(const float* __restrict__ logits, const float* __restrict__ pre,
                           const float* __restrict__ log_odds, const float* __restrict__ g_totals,
                           float tau, int B, int K, float* __restrict__ g_logits,
                           float* __restrict__ g_pre) {
  const int idx = blockIdx.x * kBwdThreads + threadIdx.x;
  if (idx >= B * K) return;
  const float g = g_totals[idx / K];
  const float yt = __fmul_rn(pre[idx], tau);
  const float e_q = expf(__fadd_rn(-yt, logits[idx]));
  const float e_p = expf(__fadd_rn(-yt, log_odds[idx]));
  const float s2_q = __fadd_rn(__fadd_rn(e_q, 1.0f), kEps);
  const float s2_p = __fadd_rn(__fadd_rn(e_p, 1.0f), kEps);
  const float m_q = __fmul_rn(__fdiv_rn(__fmul_rn(-g, 2.0f), s2_q), e_q);
  const float m_p = __fmul_rn(__fdiv_rn(__fmul_rn(g, 2.0f), s2_p), e_p);
  g_logits[idx] = __fadd_rn(g, m_q);
  g_pre[idx] = __fadd_rn(__fmul_rn(__fadd_rn(g, -m_p), tau), __fmul_rn(__fadd_rn(-g, -m_q), tau));
}

}  // namespace

extern "C" {

const char* count_prior_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// pres, logits, pre [B,K] -> totals [B] (each image's KL summed over its
// cells) and log_odds [B,K] (each cell's prior log-odds, for the backward).
// prior: a device float (may be null: then prior_value). log_tau:
// log(tau + 1e-8) in float32. Returns cudaErrorInvalidValue for K out of
// range (above kMaxCells, 3071), else the launch's cudaError_t; B = 0 launches nothing.
int count_prior_fwd(const float* pres, const float* logits, const float* pre, const float* prior,
                    float prior_value, float tau, float log_tau, int B, int K, float* totals,
                    float* log_odds, void* stream) {
  if (B < 0 || K < 0 || K > kMaxCells) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const dim3 grid((B + kWarps - 1) / kWarps);
  const size_t smem = sizeof(float) * kWarps * (K + 1);
  count_prior_fwd_kernel<<<grid, kWarps * 32, smem, (cudaStream_t)stream>>>(
      pres, logits, pre, prior, prior_value, tau, log_tau, B, K, totals, log_odds);
  return (int)cudaGetLastError();
}

// g_totals [B] -> g_logits, g_pre [B,K], from the forward's log_odds.
// B K = 0 launches nothing.
int count_prior_bwd(const float* logits, const float* pre, const float* log_odds,
                    const float* g_totals, float tau, int B, int K, float* g_logits, float* g_pre,
                    void* stream) {
  if (B < 0 || K < 0 || (long long)B * K >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  if (B * K == 0) return 0;
  const dim3 grid((B * K + kBwdThreads - 1) / kBwdThreads);
  count_prior_bwd_kernel<<<grid, kBwdThreads, 0, (cudaStream_t)stream>>>(
      logits, pre, log_odds, g_totals, tau, B, K, g_logits, g_pre);
  return (int)cudaGetLastError();
}

}  // extern "C"
