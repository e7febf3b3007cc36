// Linear-chain CRF log-partition for Hopper (sm_90a): the forward (alpha)
// recursion and its backward, bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/crf.py `_fwd_kernel` (launched by
// `_alpha_call`) and `_bwd_kernel` (launched by `_crf_bwd`), the Pallas TPU
// kernels that run the whole time loop of the CRF's partition function
// with the [B, L] state and the [L, L] transitions resident in VMEM. The
// TPU's grid is sequential, so its backward runs the beta recursion, the
// unary posteriors and the pairwise accumulator in one time loop. Here only
// what is truly serial stays in a loop, and the work is four kernels:
//   crf_fwd            alphas [T, B, L] (one block of W warps per batch row);
//   crf_bwd            the beta recursion alone: betas [T, B, L] (one warp
//                      per batch row);
//   crf_bwd_marginals  d_em [T, B, L] and each row's ct-weighted pairwise
//                      marginals [B, L, L] from the alphas and the betas,
//                      every (t, b) at once;
//   crf_bwd_reduce     d_trans = (sum over rows of the pairwise marginals)
//                      * exp(trans), the rows summed in a fixed order.
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
// What crf_bwd computes for row b, t from T-1 down to 0 (beta_{T-1} =
// `end`):
//   betas[t] = beta_t
//   beta_{t-1} = m > 0 ? log(max(exp(v - mx) @ exp(trans - mt)^T, 1e-30))
//                        + mx + mt : beta_t,      v = em[t] + beta_t
// (beta_{-1} is never read, so t = 0 runs no product). What
// crf_bwd_marginals computes for every (t, b) (alpha_{-1} is the NEG row;
// c = ct[b], the cotangent of logz[b]):
//   d_em[t]  = exp(clip(alpha_t + beta_t - logz, -80, 0)) * m * c
//   s        = max(max_i alpha_{t-1}[i], -1e29)
//   ea_t     = exp(alpha_{t-1} - s) * m
//   eb_t     = exp(clip(em[t] + beta_t - logz + s, -80, 80)) * c
//   partial[b] = sum over t of ea_t (outer) eb_t
// The pairwise sum depends on the recursion only through beta_t, so it
// leaves the serial loop. The +/-80 clip keeps exp() finite for |trans| <
// 80 (the second factor's exponent is bounded by -trans, positive for
// disfavoured transitions, so it must not be capped at 0); NEG, the 1e-30
// floor and the -1e29 floor on s are the TPU kernel's. A masked step (m =
// 0) adds ea = 0 and keeps beta; t = 0 adds exp(NEG + 1e29) = 0.
//
// Layout: time-major, as the TPU kernel's: em, alphas, betas and d_em [T,
// B, L], mask [T, B], start and end [L], trans [L, L] (trans[i][j] scores
// tag i -> tag j), logz and ct [B]; the pairwise marginals [B, L, L],
// d_trans [L, L]. All float32, all contiguous.
//
// Bounds on an H100 SXM at B=32, T=512, L=67 with lengths 256 to 512
// (some 12,000 valid transitions): the forward's and the beta recursion's
// products are 2 L^2 flops a valid transition (0.11 GFLOP each, some 1.6
// us on the CUDA cores at 67 TFLOP/s) against 8.8 MB each of em in and
// alphas or betas out (some 2.6 us at 3.35 TB/s); the marginals' outer
// products as many flops against some 17.6 MB (em, alphas, betas in, d_em
// out: 5.3 us). Bytes bound all three, and the two recursions' time loops
// are serial: a chain of T dependent steps, so they sit far above that
// bound. Splitting the backward adds the betas' 4.4 MB written and read
// (some 2.6 us).
//
// Design of crf_fwd. On the TPU the step is one [B, L] @ [L, L] product
// because the matrix unit wants it; on Hopper every batch row's recursion
// is independent, so a block owns one row and loops over T inside the
// block, with no grid barrier. The block is W warps (kernels/crf.py
// crf_fwd_plan: 4 up to L = 128, 8 above). Lane l holds tags l + 32k, k <
// K = ceil(L / 32), of alpha in EVERY warp, and warp w holds the rows [w IS,
// (w + 1) IS) of exp(trans - mt) for its lanes' tags in registers, IS =
// 4 ceil(L / 4W) (at L = 67: 20 rows x 3 tags, 60 floats a lane), so no
// step reads the matrix from shared memory. A step: the max of alpha_{t-1}
// in one redux.sync (the floats' bits as order-preserving ints: exact);
// exp(alpha - mx) into the warp's own row of shared memory under
// __syncwarp(); the warp's K partial dot products over its rows, from
// registers and float4 broadcasts of that row; the partials into a
// double-buffered [2][W][32K] array; ONE block barrier; then every warp
// sums the W partials of its lanes' tags in the same fixed order and
// forms alpha_t. Every warp runs the same instructions on the same data,
// so every warp holds bit-identical alphas and the same mx: that is why
// one barrier a step is enough (the double buffer keeps a fast warp's next
// partials off the ones a slow warp may still read). The per-tag work is
// selects, not branches, so the K exps and logs of a lane overlap. The log
// is the SFU's __logf: its error (some 1e-7 absolute on these sums) is far
// below a float ulp of the alphas (1.2e-4 at |alpha| ~ 2000), and the
// alphas stay within CRF_FWD_RTOL of the plain version (chip_smoke.py).
// The next PF steps' em and mask are in flight during a step.
//
// Design of crf_bwd. One warp owns a row (a block of 32 threads, so B = 32
// rows spread over 32 SMs), lane l owning tags l, l + 32, ...: K =
// ceil(L/32) of them, 3 at L = 67, 6 at L = 169. A step has no block
// barrier: the max is warp shuffles, the vector exp(v - mx) goes through
// shared memory under __syncwarp(), and each lane forms its K dot products
// from exp(trans - mt) in shared memory, each tag's row of L floats
// contiguous and padded to an odd number of float4s, so a lane reads 16
// bytes at a time and a quarter-warp's 8 rows fall in distinct banks (four
// partial sums a tag, the float4's lanes). The next step's em and mask are
// in flight during a step.
//
// Design of crf_bwd_marginals. Each row's pairwise sum is an [L, T] x [T,
// L] product: a block of 16 x 16 threads owns a row and an 80 x 80 tile of
// its marginals (one block at L <= 80, 3 x 3 at L = 169), 5 x 5 outputs a
// thread, and walks T in chunks of 32 steps from the last: the chunk's ea
// and eb (and, in the blocks of the first row tile, d_em) are formed by all
// its threads into shared memory, then summed into the thread's outputs in
// order of descending t, as the TPU kernel's loop does. The sum runs in a
// fixed order in one block, with no atomics: two launches give the same
// bits. The pairwise sum runs over the batch on the TPU (the contraction
// over B in the step's product); across blocks it would need atomics, so
// crf_bwd_reduce sums the B partials in a fixed order.

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Max of v over the warp in one redux.sync, exact: a float's bits as a
// signed int, the magnitude bits of a negative one flipped, order as the
// floats do (no NaN reaches it)
__device__ __forceinline__ float warp_max_redux(float v) {
  int i = __float_as_int(v);
  i = __reduce_max_sync(0xffffffffu, i >= 0 ? i : i ^ 0x7fffffff);
  return __int_as_float(i >= 0 ? i : i ^ 0x7fffffff);
}

// crf_bwd's row of exp(trans - mt), in floats: L padded to a multiple of 4
// whose number of float4s is odd
__host__ __device__ __forceinline__ int bwd_pitch(int L) {
  return 4 * (((L + 3) / 4) | 1);
}

// crf_bwd's shared memory: exp(trans - mt) [L][pitch], exp(v - mx) [pitch]
size_t bwd_smem_bytes(int L) {
  return sizeof(float) * ((size_t)L + 1) * bwd_pitch(L);
}

// tags a lane of crf_bwd at most (L <= 192)
constexpr int BWD_MAX_K = 6;

// crf_fwd's slice of exp(trans - mt) a warp: IS(L, W) rows, a multiple of
// 4 so that a warp's rows start on a float4
__host__ __device__ __forceinline__ int fwd_slice(int L, int W) {
  return 4 * ((L + 4 * W - 1) / (4 * W));
}

// one batch row over W warps (a block of 32 W threads, grid B); lane l
// holds tags l + 32k, k < K, of alpha in every warp, and warp w the rows
// [w IS, (w + 1) IS) of exp(trans - mt) for those tags in registers, IS =
// fwd_slice(L, W). See the note at the top of the file.
template <int K, int W, int IS>
__global__ void __launch_bounds__(32 * W)
crf_fwd_kernel(const float* __restrict__ em, const float* __restrict__ mask,
               const float* __restrict__ start,
               const float* __restrict__ trans, float* __restrict__ alphas,
               int B, int T, int L) {
  constexpr int ROW = W * IS > 32 * K ? W * IS : 32 * K;
  constexpr int PF = K >= 5 ? 2 : 4;     // steps of em in flight
  constexpr int NC = K >= 4 ? 1 : 2;     // chains of fmas a tag
  __shared__ __align__(16) float ea[W][ROW];   // each warp's exp(alpha - mx)
  __shared__ float part[2][W][32 * K];         // the warps' partial products
  __shared__ float red[W];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, b = blockIdx.x;
  const int i0 = w * IS;
  const size_t row = (size_t)b * L;       // row b within one step
  const size_t step = (size_t)B * L;      // one step of em / alphas

  float mt = -INFINITY;
  for (int x = threadIdx.x; x < L * L; x += 32 * W) mt = fmaxf(mt, trans[x]);
  mt = warp_max(mt);
  if (lane == 0) red[w] = mt;
  for (int x = lane; x < ROW; x += 32) ea[w][x] = 0.f;
  __syncthreads();
  mt = red[0];
  for (int v = 1; v < W; ++v) mt = fmaxf(mt, red[v]);

  float et[IS][K];              // exp(trans[i0 + ii][lane + 32k] - mt)
#pragma unroll
  for (int ii = 0; ii < IS; ++ii)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int i = i0 + ii, j = lane + 32 * k;
      et[ii][k] = i < L && j < L ? expf(trans[(size_t)i * L + j] - mt)
                                 : 0.f;
    }
  bool live[K];
  float a[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + 32 * k;
    live[k] = j < L;
    a[k] = live[k] ? start[j] + em[row + j] : -INFINITY;
    if (live[k] && k % W == w) alphas[row + j] = a[k];
  }
  // ring[jj]: the emissions and mask of a step to come, PF steps ahead
  float ring[PF][K], mring[PF];
#pragma unroll
  for (int jj = 0; jj < PF; ++jj) {
    const int t = 1 + jj;
#pragma unroll
    for (int k = 0; k < K; ++k)
      ring[jj][k] = t < T && live[k] ? em[t * step + row + lane + 32 * k]
                                     : 0.f;
    mring[jj] = t < T ? mask[(size_t)t * B + b] : 0.f;
  }
  const float4* ea4 = reinterpret_cast<const float4*>(&ea[w][i0]);
  int par = 0;
  for (int t0 = 1; t0 < T; t0 += PF) {
#pragma unroll
    for (int jj = 0; jj < PF; ++jj) {
      const int t = t0 + jj;
      if (t >= T) break;                 // the same for the whole block
      float e[K];
#pragma unroll
      for (int k = 0; k < K; ++k) e[k] = ring[jj][k];
      const float m = mring[jj];
      const int tn = t + PF;
      if (tn < T) {
#pragma unroll
        for (int k = 0; k < K; ++k)
          if (live[k]) ring[jj][k] = em[tn * step + row + lane + 32 * k];
        mring[jj] = mask[(size_t)tn * B + b];
      }
      if (!(1.f - m > 0.f)) {            // m is the same for the whole block
        // mx = max alpha_{t-1}, the same in every warp
        float mx = -INFINITY;
#pragma unroll
        for (int k = 0; k < K; ++k) mx = fmaxf(mx, a[k]);
        mx = warp_max_redux(mx);
        __syncwarp();                    // the last step's reads are done
#pragma unroll
        for (int k = 0; k < K; ++k)      // 0 at the dead tags (a = -inf)
          ea[w][lane + 32 * k] = expf(a[k] - mx);
        __syncwarp();
        // the warp's partial products over its rows, from registers
        float p[NC][K];
#pragma unroll
        for (int c = 0; c < NC; ++c)
#pragma unroll
          for (int k = 0; k < K; ++k) p[c][k] = 0.f;
#pragma unroll
        for (int q = 0; q < IS / 4; ++q) {   // et is 0 past the warp's rows
          const float4 x = ea4[q];
#pragma unroll
          for (int k = 0; k < K; ++k) {
            p[0][k] = fmaf(x.x, et[4 * q][k], p[0][k]);
            p[NC - 1][k] = fmaf(x.y, et[4 * q + 1][k], p[NC - 1][k]);
            p[0][k] = fmaf(x.z, et[4 * q + 2][k], p[0][k]);
            p[NC - 1][k] = fmaf(x.w, et[4 * q + 3][k], p[NC - 1][k]);
          }
        }
#pragma unroll
        for (int k = 0; k < K; ++k)
          part[par][w][lane + 32 * k] = NC == 2 ? p[0][k] + p[NC - 1][k]
                                                : p[0][k];
        __syncthreads();                 // the step's one block barrier
        // every warp sums the W partials in the same order: equal alphas
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float s = part[par][0][lane + 32 * k];
#pragma unroll
          for (int v = 1; v < W; ++v) s += part[par][v][lane + 32 * k];
          // a select, not a branch: the K logs overlap
          const float nx = __logf(fmaxf(s, 1e-30f)) + mx + mt + e[k];
          a[k] = live[k] ? nx : -INFINITY;
        }
        par ^= 1;
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (live[k] && k % W == w)
          alphas[t * step + row + lane + 32 * k] = a[k];
    }
  }
}

// one warp a batch row (blocks of 32 threads, grid B), lane l owning tags
// l + 32k, k < K. See the note at the top of the file.
template <int K>
__global__ void __launch_bounds__(32)
crf_bwd_kernel(const float* __restrict__ em, const float* __restrict__ mask,
               const float* __restrict__ end,
               const float* __restrict__ trans, float* __restrict__ betas,
               int B, int T, int L) {
  extern __shared__ __align__(16) float smem[];
  const int P = bwd_pitch(L);
  float* etr = smem;            // [L][P]: exp(trans[i][j] - mt), 0 past L
  float* ev = etr + L * P;      // [P]: exp(v - mx), 0 past L
  const int b = blockIdx.x, lane = threadIdx.x;
  const size_t row = (size_t)b * L;
  const size_t step = (size_t)B * L;

  float mt = -INFINITY;
  for (int k = lane; k < L * L; k += 32) mt = fmaxf(mt, trans[k]);
  mt = warp_max(mt);
  for (int k = lane; k < L * P; k += 32) {
    const int i = k / P, j = k % P;
    etr[k] = j < L ? expf(trans[i * L + j] - mt) : 0.f;
  }
  for (int k = lane; k < P; k += 32) ev[k] = 0.f;
  // (the first product's __syncwarp orders these writes before its reads)

  bool live[K];
  float beta[K], e_nx[K];
  const float4* erow[K];        // the lane's tags' rows of exp(trans - mt)
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int i = lane + 32 * k;
    live[k] = i < L;
    beta[k] = live[k] ? end[i] : 0.f;
    e_nx[k] = live[k] ? em[(size_t)(T - 1) * step + row + i] : 0.f;
    erow[k] = reinterpret_cast<const float4*>(etr + (live[k] ? i : 0) * P);
  }
  float m_nx = mask[(size_t)(T - 1) * B + b];
  const float4* ev4 = reinterpret_cast<const float4*>(ev);
  for (int t = T - 1; t >= 0; --t) {
    float e[K];
#pragma unroll
    for (int k = 0; k < K; ++k) e[k] = e_nx[k];
    const float m = m_nx;
    if (t > 0) {                         // step t-1's inputs in flight
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (live[k])
          e_nx[k] = em[(size_t)(t - 1) * step + row + lane + 32 * k];
      m_nx = mask[(size_t)(t - 1) * B + b];
    }
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (live[k]) betas[(size_t)t * step + row + lane + 32 * k] = beta[k];
    if (t > 0 && m > 0.f) {              // m is the same for the whole warp
      // beta_{t-1}[i] = LSE_j trans[i][j] + em[t][j] + beta_t[j]
      float v[K], mx = -INFINITY;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        v[k] = live[k] ? e[k] + beta[k] : -INFINITY;
        mx = fmaxf(mx, v[k]);
      }
      mx = warp_max(mx);
      __syncwarp();                      // the last product's reads are done
#pragma unroll
      for (int k = 0; k < K; ++k)
        if (live[k]) ev[lane + 32 * k] = expf(v[k] - mx);
      __syncwarp();
      float p[K][4];
#pragma unroll
      for (int k = 0; k < K; ++k) p[k][0] = p[k][1] = p[k][2] = p[k][3] = 0.f;
#pragma unroll 4
      for (int q = 0; q < P / 4; ++q) {
        const float4 x = ev4[q];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const float4 w = erow[k][q];
          p[k][0] = fmaf(x.x, w.x, p[k][0]);
          p[k][1] = fmaf(x.y, w.y, p[k][1]);
          p[k][2] = fmaf(x.z, w.z, p[k][2]);
          p[k][3] = fmaf(x.w, w.w, p[k][3]);
        }
      }
#pragma unroll
      for (int k = 0; k < K; ++k)
        beta[k] = logf(fmaxf((p[k][0] + p[k][1]) + (p[k][2] + p[k][3]),
                             1e-30f)) + mx + mt;
    }
  }
}

constexpr int MT = 16;                    // threads along a tile's side
constexpr int MR = 5;                     // outputs a thread along a side
constexpr int MTILE = MT * MR;            // tags along a tile's side
constexpr int MTHREADS = MT * MT;
constexpr int MWARPS = MTHREADS / 32;
constexpr int MTC = 32;                   // steps a chunk
constexpr int MSW = MTC / MWARPS;         // steps a warp in a chunk's max
constexpr int MPER = MTC * MTILE / MTHREADS;  // (step, tag) pairs a thread

// a chunk's inputs, as loaded: for the max of alpha_{t-1} the warp's MSW
// steps (warp + MWARPS q) and the lane's tags (lane + 32k) and masks; for
// the factors the thread's MPER (step, tag) pairs' alpha_{t-1} (the row
// tile's tags; -inf at t = 0 and past L, so that ea is 0 there), and
// alpha_t, beta_t and em[t] (the column tile's)
struct Chunk {
  float sa[MSW][BWD_MAX_K], m[MSW];
  float ap[MPER], al[MPER], bt[MPER], em[MPER];
};

__device__ __forceinline__ void load_chunk(
    Chunk& x, const float* __restrict__ em, const float* __restrict__ mask,
    const float* __restrict__ alphas, const float* __restrict__ betas, int b,
    int B, int L, int i0, int j0, bool first, int c0, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t row = (size_t)b * L, step = (size_t)B * L;
#pragma unroll
  for (int q = 0; q < MSW; ++q) {
    const int tl = warp + MWARPS * q, t = c0 + tl;
#pragma unroll
    for (int k = 0; k < BWD_MAX_K; ++k) {
      const int i = lane + 32 * k;
      x.sa[q][k] = tl < n && t > 0 && i < L
                       ? alphas[(size_t)(t - 1) * step + row + i]
                       : -INFINITY;
    }
    x.m[q] = tl < n ? mask[(size_t)t * B + b] : 0.f;
  }
#pragma unroll
  for (int u = 0; u < MPER; ++u) {
    const int e = tid + MTHREADS * u, tl = e / MTILE, k = e % MTILE;
    const int t = c0 + tl, i = i0 + k, j = j0 + k;
    x.ap[u] = tl < n && t > 0 && i < L
                  ? alphas[(size_t)(t - 1) * step + row + i] : -INFINITY;
    const bool ok = tl < n && j < L;
    const size_t at = (size_t)t * step + row + j;
    x.bt[u] = ok ? betas[at] : 0.f;
    x.em[u] = ok ? em[at] : 0.f;
    x.al[u] = ok && first ? alphas[at] : 0.f;
  }
}

// grid (B, ceil(L / MTILE), ceil(L / MTILE)): block (b, y, z) sums rows
// [y MTILE, ..) and columns [z MTILE, ..) of row b's pairwise marginals;
// the blocks with y = 0 write d_em of their columns. See the note at the
// top of the file.
__global__ void __launch_bounds__(MTHREADS)
crf_bwd_marginals_kernel(const float* __restrict__ em,
                         const float* __restrict__ mask,
                         const float* __restrict__ alphas,
                         const float* __restrict__ betas,
                         const float* __restrict__ logz,
                         const float* __restrict__ ct,
                         float* __restrict__ d_em,
                         float* __restrict__ partial, int B, int T, int L) {
  __shared__ float ea_s[MTC][MTILE], eb_s[MTC][MTILE];
  __shared__ float s_s[MTC], m_s[MTC];
  const int b = blockIdx.x, i0 = blockIdx.y * MTILE, j0 = blockIdx.z * MTILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid % MT, ty = tid / MT;
  const bool first = blockIdx.y == 0;
  const size_t row = (size_t)b * L, step = (size_t)B * L;
  const float lz = logz[b], c = ct[b];
  float acc[MR][MR];
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int q = 0; q < MR; ++q) acc[r][q] = 0.f;

  // chunks of steps [c0, c1) from the last; the next chunk's inputs load
  // during this chunk's sums
  Chunk x;
  int c1 = T, c0 = max(0, T - MTC);
  load_chunk(x, em, mask, alphas, betas, b, B, L, i0, j0, first, c0, c1 - c0);
  while (c1 > 0) {
    const int n = c1 - c0;
    // s_t = max(max_i alpha_{t-1}[i], -1e29), a warp a step
#pragma unroll
    for (int q = 0; q < MSW; ++q) {
      float s = x.sa[q][0];
#pragma unroll
      for (int k = 1; k < BWD_MAX_K; ++k) s = fmaxf(s, x.sa[q][k]);
      s = warp_max(s);
      const int tl = warp + MWARPS * q;
      if (lane == 0 && tl < n) {
        s_s[tl] = fmaxf(s, -1e29f);
        m_s[tl] = x.m[q];
      }
    }
    __syncthreads();
    // the chunk's factors ea and eb, and d_em
#pragma unroll
    for (int u = 0; u < MPER; ++u) {
      const int e = tid + MTHREADS * u, tl = e / MTILE, k = e % MTILE;
      if (tl < n) {
        const float s = s_s[tl], m = m_s[tl];
        ea_s[tl][k] = expf(x.ap[u] - s) * m;
        float eb = 0.f;
        if (j0 + k < L) {
          eb = expf(fminf(fmaxf(x.em[u] + x.bt[u] - lz + s, -80.f), 80.f)) *
               c;
          if (first)
            d_em[(size_t)(c0 + tl) * step + row + j0 + k] =
                expf(fminf(fmaxf(x.al[u] + x.bt[u] - lz, -80.f), 0.f)) * m *
                c;
        }
        eb_s[tl][k] = eb;
      }
    }
    __syncthreads();
    c1 = c0;
    c0 = max(0, c1 - MTC);
    if (c1 > 0)
      load_chunk(x, em, mask, alphas, betas, b, B, L, i0, j0, first, c0,
                 c1 - c0);
    // acc += ea_t (outer) eb_t, t descending
#pragma unroll 4
    for (int tl = n - 1; tl >= 0; --tl) {
      float a[MR], f[MR];
#pragma unroll
      for (int r = 0; r < MR; ++r) {
        a[r] = ea_s[tl][ty + MT * r];
        f[r] = eb_s[tl][tx + MT * r];
      }
#pragma unroll
      for (int r = 0; r < MR; ++r)
#pragma unroll
        for (int q = 0; q < MR; ++q) acc[r][q] = fmaf(a[r], f[q], acc[r][q]);
    }
    __syncthreads();
  }
  float* out = partial + (size_t)b * L * L;
#pragma unroll
  for (int r = 0; r < MR; ++r)
#pragma unroll
    for (int q = 0; q < MR; ++q) {
      const int i = i0 + ty + MT * r, j = j0 + tx + MT * q;
      if (i < L && j < L) out[(size_t)i * L + j] = acc[r][q];
    }
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

template <int K>
cudaError_t launch_bwd(const float* em, const float* mask, const float* end,
                       const float* trans, float* betas, int B, int T, int L,
                       cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(L);
  cudaError_t err = cudaFuncSetAttribute(
      crf_bwd_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  crf_bwd_kernel<K><<<B, 32, smem, stream>>>(em, mask, end, trans, betas, B,
                                             T, L);
  return cudaGetLastError();
}

}  // namespace

// crf_fwd_kernel's instances (K, W, IS): K = ceil(L / 32) tags a lane, W
// warps a row, IS = fwd_slice(L, W) rows of exp(trans) a warp;
// kernels/crf.py _FWD_INSTANCES mirrors it
#define CRF_FWD_INSTANCES(X)                                               \
  X(1, 4, 4) X(1, 4, 8) X(2, 4, 12) X(2, 4, 16) X(3, 1, 68) X(3, 2, 36)    \
  X(3, 4, 20) X(3, 4, 24) X(3, 8, 12) X(4, 4, 28) X(4, 4, 32) X(4, 8, 16)  \
  X(5, 8, 20) X(6, 8, 24) X(6, 16, 12)

extern "C" {

// Launch on `stream` of the current device, a block of W warps a batch
// row; return the cudaError_t of the launch (0 on success),
// cudaErrorInvalidValue where no instance of crf_fwd_kernel takes (L, W).
int crf_fwd(const float* em, const float* mask, const float* start,
            const float* trans, float* alphas, int B, int T, int L, int W,
            void* stream) {
  if (B < 1 || T < 1 || L < 1 || L > 32 * BWD_MAX_K || W < 1)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int K = (L + 31) / 32, is = fwd_slice(L, W);
#define CRF_FWD_TRY(k, w, rows)                                           \
  if (K == k && W == w && is == rows) {                                   \
    crf_fwd_kernel<k, w, rows><<<B, 32 * w, 0, st>>>(em, mask, start,      \
                                                    trans, alphas, B, T, L); \
    return (int)cudaGetLastError();                                       \
  }
  CRF_FWD_INSTANCES(CRF_FWD_TRY)
#undef CRF_FWD_TRY
  return (int)cudaErrorInvalidValue;
}

// The beta recursion, one warp per batch row, L up to 192.
int crf_bwd(const float* em, const float* mask, const float* end,
            const float* trans, float* betas, int B, int T, int L,
            void* stream) {
  if (B < 1 || T < 1 || L < 1 || L > 32 * BWD_MAX_K)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch ((L + 31) / 32) {
    case 1:
      return (int)launch_bwd<1>(em, mask, end, trans, betas, B, T, L, st);
    case 2:
      return (int)launch_bwd<2>(em, mask, end, trans, betas, B, T, L, st);
    case 3:
      return (int)launch_bwd<3>(em, mask, end, trans, betas, B, T, L, st);
    case 4:
      return (int)launch_bwd<4>(em, mask, end, trans, betas, B, T, L, st);
    case 5:
      return (int)launch_bwd<5>(em, mask, end, trans, betas, B, T, L, st);
    default:
      return (int)launch_bwd<6>(em, mask, end, trans, betas, B, T, L, st);
  }
}

// d_em and the rows' pairwise marginals from the alphas and betas, L up to
// 192: grid (B, ceil(L / 80), ceil(L / 80)) of 256 threads.
int crf_bwd_marginals(const float* em, const float* mask, const float* alphas,
                      const float* betas, const float* logz, const float* ct,
                      float* d_em, float* partial, int B, int T, int L,
                      void* stream) {
  if (B < 1 || T < 1 || L < 1 || L > 32 * BWD_MAX_K)
    return (int)cudaErrorInvalidValue;
  const int tiles = (L + MTILE - 1) / MTILE;
  crf_bwd_marginals_kernel<<<dim3(B, tiles, tiles), MTHREADS, 0,
                             (cudaStream_t)stream>>>(
      em, mask, alphas, betas, logz, ct, d_em, partial, B, T, L);
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

const char* crf_bwd_marginals_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* crf_bwd_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
