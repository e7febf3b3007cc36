// Linear-chain CRF log-partition for Hopper (sm_90a): the forward (alpha)
// recursion and its backward, bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/crf.py `_fwd_kernel` (launched by
// `_alpha_call`) and `_bwd_kernel` (launched by `_crf_bwd`), the Pallas TPU
// kernels that run the whole time loop of the CRF's partition function
// with the [B, L] state and the [L, L] transitions resident in VMEM. Here
// that work is three kernels:
//   crf_fwd         alphas [T, B, L] (one block per batch row);
//   crf_bwd         d_em [T, B, L] and each row's ct-weighted pairwise
//                   marginals [B, L, L] (one block per batch row);
//   crf_bwd_reduce  d_trans = (sum over rows of the pairwise marginals)
//                   * exp(trans), the rows summed in a fixed order.
//
// What crf_fwd computes for batch row b (m = mask[t, b], mt = max(trans)):
//   alpha_0 = start + em[0]
//   alpha_t = log(max(exp(alpha_{t-1} - mx) @ exp(trans - mt), 1e-30))
//             + mx + mt + em[t]          mx = max_i alpha_{t-1}[i]
//   a step with 1 - m > 0 keeps alpha_{t-1} (a select, not a blend)
// and writes alpha_t at every step, padded ones too: the backward reads
// them. logz = LSE(alpha_{T-1} + end) is formed by the wrapper, as the TPU
// package forms it outside its kernel.
//
// What crf_bwd computes for row b, t from T-1 down to 0 (beta starts at
// `end`; alpha_{-1} is the NEG row; c = ct[b], the cotangent of logz[b]):
//   d_em[t]  = exp(clip(alpha_t + beta - logz, -80, 0)) * m * c
//   s        = max(max_i alpha_{t-1}[i], -1e29)
//   ea       = exp(alpha_{t-1} - s) * m
//   eb       = exp(clip(em[t] + beta - logz + s, -80, 80)) * c
//   acc     += ea (outer) eb
//   beta     = m > 0 ? log(max(exp(v - mx) @ exp(trans - mt)^T, 1e-30))
//                      + mx + mt : beta,      v = em[t] + beta
// The +/-80 clip keeps exp() finite for |trans| < 80 (the second factor's
// exponent is bounded by -trans, positive for disfavoured transitions, so
// it must not be capped at 0); NEG, the 1e-30 floor and the -1e29 floor on
// s are the TPU kernel's. Steps the TPU kernel computes to no effect are
// skipped, with the same result: a masked step (m = 0) adds ea = 0 to acc
// and keeps beta, and t = 0 adds exp(NEG + 1e29) = 0 to acc, its beta is
// never read.
//
// Layout: time-major, as the TPU kernel's: em, alphas and d_em [T, B, L],
// mask [T, B], start and end [L], trans [L, L] (trans[i][j] scores tag i ->
// tag j), logz and ct [B]; the pairwise marginals [B, L, L], d_trans
// [L, L]. All float32, all contiguous.
//
// Bound on an H100 SXM at B=32, T=512, L=67 with lengths 256 to 512: the
// forward's products are 2 L^2 flops a valid (row, step) pair (0.11 GFLOP,
// some 1.6 us on the CUDA cores at 67 TFLOP/s) against 8.8 MB of em in and
// alphas out (some 2.6 us at 3.35 TB/s); the backward's are 4 L^2 a pair
// against some 13 MB. Bytes bound both. The time loop is serial, a chain
// of T dependent steps of a few hundred cycles each, so each kernel sits
// far above that bound.
//
// Design. On the TPU the step is one [B, L] @ [L, L] product because the
// matrix unit wants it; on Hopper every batch row's recursion is
// independent, so a block owns one row and loops over T inside the block,
// with no grid barrier. Thread j owns tag j (L threads rounded up to a
// warp); exp(trans - mt) lives in shared memory (L^2 floats, 18 KB at
// L=67), the forward's copy as it is and the backward's transposed, so
// that thread j reads consecutive addresses in both products. A step is a
// block max, L exps and one length-L dot product a thread (four partial
// sums), with the next step's inputs already loading into registers. The
// pairwise sum runs over the batch on the TPU (the contraction over B in
// the step's product); across blocks it would need atomics, so each block
// sums its row's ea (outer) eb over T into shared memory (thread j owns
// column j), writes it out once, and crf_bwd_reduce sums the B partials in
// a fixed order: two runs give the same bits. B=32 rows give 32 blocks on
// 132 SMs.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max of v over the block, through one float a warp in `red`. One barrier:
// the caller puts another between two calls (red is rewritten).
__device__ __forceinline__ float block_max(float v, float* red) {
  v = warp_max(v);
  const int nw = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float m = red[0];
  for (int w = 1; w < nw; ++w) m = fmaxf(m, red[w]);
  return m;
}

// sum_i x[i] * w[i * L + j]: four partial sums, so the chain of dependent
// fmas is L / 4 long
__device__ __forceinline__ float dot_column(const float* x, const float* w,
                                            int j, int L) {
  float p0 = 0.f, p1 = 0.f, p2 = 0.f, p3 = 0.f;
  int i = 0;
  for (; i + 4 <= L; i += 4) {
    p0 = fmaf(x[i], w[i * L + j], p0);
    p1 = fmaf(x[i + 1], w[(i + 1) * L + j], p1);
    p2 = fmaf(x[i + 2], w[(i + 2) * L + j], p2);
    p3 = fmaf(x[i + 3], w[(i + 3) * L + j], p3);
  }
  for (; i < L; ++i) p0 = fmaf(x[i], w[i * L + j], p0);
  return (p0 + p1) + (p2 + p3);
}

// mt = max(trans) over the block (ends with the barrier block_max asks for)
__device__ __forceinline__ float trans_max(const float* trans, int L,
                                           float* red) {
  float v = -INFINITY;
  for (int k = threadIdx.x; k < L * L; k += blockDim.x)
    v = fmaxf(v, trans[k]);
  const float mt = block_max(v, red);
  __syncthreads();
  return mt;
}

size_t fwd_smem_bytes(int L) {
  return sizeof(float) * ((size_t)L * L + L + 32);
}

size_t bwd_smem_bytes(int L) {
  return sizeof(float) * (2 * (size_t)L * L + 2 * L + 32);
}

int threads_for(int L) { return (L + 31) / 32 * 32; }

__global__ void crf_fwd_kernel(const float* __restrict__ em,
                               const float* __restrict__ mask,
                               const float* __restrict__ start,
                               const float* __restrict__ trans,
                               float* __restrict__ alphas, int B, int T,
                               int L) {
  extern __shared__ __align__(16) float smem[];
  float* etr = smem;             // [L][L]  exp(trans - mt)
  float* ea = etr + L * L;       // [L]     exp(alpha_{t-1} - mx)
  float* red = ea + L;           // [32]
  const int b = blockIdx.x, j = threadIdx.x;
  const bool live = j < L;
  const size_t row = (size_t)b * L;       // row b within one step
  const size_t step = (size_t)B * L;      // one step of em / alphas

  const float mt = trans_max(trans, L, red);
  for (int k = j; k < L * L; k += blockDim.x) etr[k] = expf(trans[k] - mt);
  // (the first step's barriers order these writes before any read)

  float a = live ? start[j] + em[row + j] : 0.f;
  if (live) alphas[row + j] = a;
  float e_next = 0.f, m_next = 0.f;
  if (T > 1) {
    e_next = live ? em[step + row + j] : 0.f;
    m_next = mask[B + b];
  }
  for (int t = 1; t < T; ++t) {
    const float e = e_next, m = m_next;
    if (t + 1 < T) {                     // the next step's inputs in flight
      e_next = live ? em[(t + 1) * step + row + j] : 0.f;
      m_next = mask[(size_t)(t + 1) * B + b];
    }
    if (!(1.f - m > 0.f)) {              // m is the same for the whole block
      const float mx = block_max(live ? a : -INFINITY, red);
      if (live) ea[j] = expf(a - mx);
      __syncthreads();
      if (live) {
        const float prod = dot_column(ea, etr, j, L);
        a = logf(fmaxf(prod, 1e-30f)) + mx + mt + e;
      }
    }
    if (live) alphas[t * step + row + j] = a;
  }
}

__global__ void crf_bwd_kernel(const float* __restrict__ em,
                               const float* __restrict__ mask,
                               const float* __restrict__ end,
                               const float* __restrict__ trans,
                               const float* __restrict__ alphas,
                               const float* __restrict__ logz,
                               const float* __restrict__ ct,
                               float* __restrict__ d_em,
                               float* __restrict__ partial, int B, int T,
                               int L) {
  extern __shared__ __align__(16) float smem[];
  float* etr_t = smem;           // [L][L]  exp(trans[i][j] - mt) at j*L + i
  float* acc = etr_t + L * L;    // [L][L]  acc[i*L + j], thread j's column j
  float* ea = acc + L * L;       // [L]
  float* ev = ea + L;            // [L]
  float* red = ev + L;           // [32]
  const int b = blockIdx.x, j = threadIdx.x;
  const bool live = j < L;
  const size_t row = (size_t)b * L;
  const size_t step = (size_t)B * L;

  const float mt = trans_max(trans, L, red);
  for (int k = j; k < L * L; k += blockDim.x) {
    etr_t[(k % L) * L + k / L] = expf(trans[k] - mt);
    acc[k] = 0.f;
  }
  __syncthreads();

  const float lz = logz[b], c = ct[b];
  float beta = live ? end[j] : 0.f;
  // step t's em, alpha_t, alpha_{t-1} and mask; alpha_{t-1} is the next
  // step's alpha_t, so a step loads one alpha row ahead
  const size_t last = (size_t)(T - 1) * step + row + j;
  float e_cur = live ? em[last] : 0.f;
  float al_cur = live ? alphas[last] : 0.f;
  float ap_cur = (T > 1 && live) ? alphas[last - step] : NEG;
  float m_cur = mask[(size_t)(T - 1) * B + b];
  for (int t = T - 1; t >= 0; --t) {
    const float e = e_cur, al = al_cur, ap = ap_cur, m = m_cur;
    if (t > 0) {                         // step t-1's inputs in flight
      const size_t at = (size_t)(t - 1) * step + row + j;
      e_cur = live ? em[at] : 0.f;
      al_cur = ap;
      ap_cur = (t > 1 && live) ? alphas[at - step] : NEG;
      m_cur = mask[(size_t)(t - 1) * B + b];
    }
    if (live)
      d_em[(size_t)t * step + row + j] =
          expf(fminf(fmaxf(al + beta - lz, -80.f), 0.f)) * m * c;
    if (t > 0 && m > 0.f) {              // m is the same for the whole block
      // pairwise marginals of the transition t-1 -> t
      const float s = fmaxf(block_max(live ? ap : -INFINITY, red), -1e29f);
      if (live) ea[j] = expf(ap - s) * m;
      const float eb =
          live ? expf(fminf(fmaxf(e + beta - lz + s, -80.f), 80.f)) * c : 0.f;
      __syncthreads();
      if (live)
        for (int i = 0; i < L; ++i)
          acc[i * L + j] = fmaf(ea[i], eb, acc[i * L + j]);
      // beta_{t-1}[i] = LSE_j trans[i][j] + em[t][j] + beta_t[j]; here
      // thread j computes entry i = j
      const float v = e + beta;
      const float mx = block_max(live ? v : -INFINITY, red);
      if (live) ev[j] = expf(v - mx);
      __syncthreads();
      if (live) {
        const float prod = dot_column(ev, etr_t, j, L);
        beta = logf(fmaxf(prod, 1e-30f)) + mx + mt;
      }
    }
  }
  __syncthreads();
  float* out = partial + (size_t)b * L * L;
  for (int k = j; k < L * L; k += blockDim.x) out[k] = acc[k];
}

__global__ void crf_bwd_reduce_kernel(const float* __restrict__ partial,
                                      const float* __restrict__ trans,
                                      float* __restrict__ d_trans, int B,
                                      int L) {
  const int n = L * L;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += partial[(size_t)b * n + k];
  d_trans[k] = s * expf(trans[k]);
}

}  // namespace

extern "C" {

// Launch on `stream` of the current device, one block per batch row;
// return the cudaError_t of the launch (0 on success).
int crf_fwd(const float* em, const float* mask, const float* start,
            const float* trans, float* alphas, int B, int T, int L,
            void* stream) {
  const size_t smem = fwd_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      crf_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  crf_fwd_kernel<<<B, threads_for(L), smem, (cudaStream_t)stream>>>(
      em, mask, start, trans, alphas, B, T, L);
  return (int)cudaGetLastError();
}

int crf_bwd(const float* em, const float* mask, const float* end,
            const float* trans, const float* alphas, const float* logz,
            const float* ct, float* d_em, float* partial, int B, int T,
            int L, void* stream) {
  const size_t smem = bwd_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      crf_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  crf_bwd_kernel<<<B, threads_for(L), smem, (cudaStream_t)stream>>>(
      em, mask, end, trans, alphas, logz, ct, d_em, partial, B, T, L);
  return (int)cudaGetLastError();
}

// T is unused (the C interface the port's kernels share)
int crf_bwd_reduce(const float* partial, const float* trans, float* d_trans,
                   int B, int T, int L, void* stream) {
  const int n = L * L;
  crf_bwd_reduce_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      partial, trans, d_trans, B, L);
  return (int)cudaGetLastError();
}

const char* crf_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* crf_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* crf_bwd_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
