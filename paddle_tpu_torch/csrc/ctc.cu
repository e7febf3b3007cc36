// CTC forward-backward for Hopper (sm_90a): the alpha recursion and its
// backward over the blank-interleaved label states, bound to Python
// through ctypes.
//
// Replaces: paddle_tpu/kernels/ctc.py `_fwd_kernel` (launched by
// `_alphas`) and `_bwd_kernel` (launched by `_ctc_fb_bwd`), the Pallas TPU
// kernels that run the whole time loop of CTC's forward-backward with the
// [B, S] state resident in VMEM. The TPU's grid is sequential, so its
// backward forms the posteriors inside the beta recursion's time loop.
// Here only what is truly serial stays in a loop, and the work is three
// kernels:
//   ctc_fwd            alphas [T, B, S] (one warp per batch row);
//   ctc_bwd            the beta recursion alone: betas [T, B, S] (one warp
//                      per batch row);
//   ctc_bwd_marginals  d_em [T, B, S], the negated posterior marginals
//                      times the cotangent, from the alphas and the betas,
//                      every (t, b, s) at once.
//
// S = 2U+1 states: blank, label 1, blank, label 2, ..., blank. With
//   lse3(x, y, z) = mx + log(exp(x - ms) + exp(y - ms) + exp(z - ms)),
//   mx = max(x, y, z), ms = max(mx, -1e29)
// what ctc_fwd computes for batch row b (m = mask[t, b]):
//   alpha_0[s] = em[0][s] at s < 2 where ok[s], NEG elsewhere (whatever
//                mask[0] says)
//   alpha_t[s] = ok[s] ? max(lse3(alpha[s], alpha[s-1],
//                                 skip[s] ? alpha[s-2] : NEG) + em[t][s],
//                            NEG) : NEG       (NEG left of state 0)
//   a step with 1 - m > 0 keeps alpha_{t-1} (a select, not a blend)
// and writes alpha_t at every step, padded ones too: the backward reads
// them, and ll = LSE of alpha_{T-1} at the terminal states is formed by
// the wrapper, as the TPU package forms it outside its kernel.
//
// What ctc_bwd computes for row b, t from T-1 down to 0 (beta starts at
// beta_init):
//   betas[t]   = beta
//   be[s]      = ok[s] ? beta[s] + em[t][s] : NEG
//   beta[s]    = m > 0 ? (ok[s] ? max(lse3(be[s], be[s+1],
//                                          skip[s+2] ? be[s+2] : NEG), NEG)
//                                : NEG) : beta[s]   (NEG right of S-1)
// The s+2 term is taken where the TARGET state can skip. The beta of t=0
// is never read, so it is not computed. NEG, the -1e29 floor, the clamp
// at NEG and the -80 clip are the TPU kernels': every state stays finite,
// so a dead row never turns into 0 * -inf = NaN. What ctc_bwd_marginals
// computes (ll = ll[b], c = ct[b], 1 without a cotangent):
//   d_em[t][s] = -(exp(clip(alpha_t[s] + betas[t][s] - ll, -80, 0)) * m * c)
// The posteriors depend on the recursion only through beta_t, so they
// leave the serial loop.
//
// Layout: time-major, as the TPU kernels': em, alphas, betas and d_em [T,
// B, S], mask [T, B], skip, ok and beta_init [B, S] (1.0 / 0.0 flags;
// beta_init 0.0 at the terminal states, NEG elsewhere), ll and ct [B]. All
// float32, all contiguous.
//
// Bound on an H100 SXM at T=512, B=32, S=65 (the CTC path's): each
// recursion reads em (4.3 MB) and writes a [T, B, S] output (4.3 MB), some
// 2.6 us at 3.35 TB/s; the marginals read the alphas and the betas and
// write d_em (13 MB, some 3.9 us). The arithmetic, four transcendentals
// and some ten flops a valid (row, step, state), is some 0.2 us at 67
// TFLOP/s. Bytes bound all three. The recursions' time loops are serial,
// a chain of T dependent steps of some 300 to 700 cycles each (shuffles,
// the exps and the logs of the lane's states), so they sit far above that
// bound; splitting the backward adds the betas' 4.3 MB written and read.
//
// Design. On the TPU a step is a [B, S] tile shifted along its lanes; on
// Hopper every row's recursion is independent, so one warp owns a row and
// loops over T with no barrier at all. In both recursions lane l holds the
// N consecutive states from N l in registers, N = ceil(S / 32) rounded up
// to 2, 3, 4, 6, 8, 12 or 16 (states_per_lane: 3 at S = 65, where a power
// of two would give 4 and a quarter more exps and logs). State s needs s-1
// and s-2, so a forward step takes the last two states of lane l-1 by two
// __shfl_up_sync; a backward step takes be and the skip-filtered be of the
// first states of lane l+1 by three __shfl_down_sync (any N >= 2). em does
// not depend on the recursion, so each lane keeps a ring of the next steps'
// values in registers, loaded that many steps ahead, and the load latency
// stays off the serial chain: RING steps deep at N <= 4, 4 above, where 16
// states a lane would spill a deeper ring. A block holds WARPS rows (B=32
// rows: 32 blocks on 132 SMs). At the CTC path's S = 65 on an H100, 4
// states a lane, a ring of 4 and 4 rows a block each slow the forward by
// 8 to 19% (tools/torch_ctc_fwd_step_cost.py --levers). There is no shared memory, so the kernels
// take any B, and S up to 512. lse3_top skips the exp of its largest term
// (exactly 1). expf and logf are the accurate ones: the build has no
// fast-math flag. ctc_bwd_marginals is one pass over the T B S entries.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
// rows a block; steps of em in flight at N <= 4 (4 above)
constexpr int WARPS = 1;
constexpr int RING = 8;
// the states a lane that the kernels are instantiated for
constexpr int LANE_N[] = {2, 3, 4, 6, 8, 12, 16};

// N: ceil(S / 32) rounded up to an entry of LANE_N, 0 beyond 512 states
int states_per_lane(int S) {
  const int need = (S + 31) / 32;
  for (int n : LANE_N)
    if (n >= need) return n;
  return 0;
}

// lse3 without the exp of its largest term, which is exactly 1 where mx >=
// -1e29 (then ms = mx) and exactly 0 below (mx - ms <= -ulp(1e29)). The log
// stays the accurate logf: with the SFU's __logf the posteriors at T = 2048
// reach 0.98 of CTC_BWD_RTOL against the plain version
// (tools/torch_ctc_bwd_step_cost.py --levers)
__device__ __forceinline__ float lse3_top(float x, float y, float z) {
  const float hi = fmaxf(x, y), lo = fminf(x, y);
  const float mx = fmaxf(hi, z), mid = fminf(hi, z);
  const float ms = fmaxf(mx, -1e29f);
  return mx + logf((mx >= -1e29f ? 1.f : 0.f) + expf(lo - ms) +
                   expf(mid - ms));
}

// the alpha recursion: one warp a batch row, lane l holding the N
// consecutive states from N l. See the note at the top of the file.
template <int N>
__global__ void __launch_bounds__(32 * WARPS)
ctc_fwd_kernel(const float* __restrict__ em, const float* __restrict__ mask,
               const float* __restrict__ skip, const float* __restrict__ ok,
               float* __restrict__ alphas, int B, int T, int S) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;                    // the whole warp: no barrier below
  const int s0 = lane * N;
  const size_t row = (size_t)b * S + s0;  // state s0 of row b in one step
  const size_t step = (size_t)B * S;      // one step of em / alphas

  bool in[N], live[N], can_skip[N];
  float a[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    in[k] = s0 + k < S;
    live[k] = in[k] && ok[row + k] > 0.f;
    can_skip[k] = in[k] && skip[row + k] > 0.f;
    a[k] = (s0 + k < 2 && live[k]) ? em[row + k] : NEG;
    if (in[k]) alphas[row + k] = a[k];
  }

  // ring[j]: the emissions and mask of a step to come, PF steps ahead
  constexpr int PF = N <= 4 ? RING : 4;
  float ring[PF][N], mring[PF];
#pragma unroll
  for (int j = 0; j < PF; ++j) {
    const int t = 1 + j;
#pragma unroll
    for (int k = 0; k < N; ++k)
      ring[j][k] = (t < T && in[k]) ? em[t * step + row + k] : 0.f;
    mring[j] = t < T ? mask[(size_t)t * B + b] : 0.f;
  }
  for (int t0 = 1; t0 < T; t0 += PF) {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int t = t0 + j;
      if (t >= T) break;                 // the same for the whole warp
      float e[N];
#pragma unroll
      for (int k = 0; k < N; ++k) e[k] = ring[j][k];
      const float m = mring[j];
      const int tn = t + PF;
      if (tn < T) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          if (in[k]) ring[j][k] = em[tn * step + row + k];
        mring[j] = mask[(size_t)tn * B + b];
      }
      if (!(1.f - m > 0.f)) {            // m is the same for the whole warp
        // the last two states of lane l-1 (NEG left of state 0)
        float p1 = __shfl_up_sync(FULL, a[N - 1], 1);
        float p2 = __shfl_up_sync(FULL, a[N - 2], 1);
        if (lane == 0) p1 = p2 = NEG;
        float nx[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float a1 = k >= 1 ? a[k - 1] : p1;
          const float a2 = !can_skip[k] ? NEG
                           : k >= 2     ? a[k - 2]
                           : k == 1     ? p1
                                        : p2;
          const float v = lse3_top(a[k], a1, a2) + e[k];
          nx[k] = live[k] ? fmaxf(v, NEG) : NEG;
        }
#pragma unroll
        for (int k = 0; k < N; ++k) a[k] = nx[k];
      }
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (in[k]) alphas[t * step + row + k] = a[k];
    }
  }
}

// the beta recursion alone: one warp a batch row, lane l holding the N
// consecutive states from N l; betas[t] = beta before it is folded with
// em[t]. See the note at the top of the file.
template <int N>
__global__ void __launch_bounds__(32 * WARPS)
ctc_bwd_kernel(const float* __restrict__ em, const float* __restrict__ mask,
               const float* __restrict__ skip, const float* __restrict__ ok,
               const float* __restrict__ beta_init,
               float* __restrict__ betas, int B, int T, int S) {
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;                    // the whole warp: no barrier below
  const int s0 = lane * N;
  const size_t row = (size_t)b * S + s0;
  const size_t step = (size_t)B * S;

  bool in[N], live[N], can_skip[N];
  float beta[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    in[k] = s0 + k < S;
    live[k] = in[k] && ok[row + k] > 0.f;
    can_skip[k] = in[k] && skip[row + k] > 0.f;
    beta[k] = in[k] ? beta_init[row + k] : NEG;
  }

  // ring[j]: the emissions and mask of a step to come, PF ahead
  constexpr int PF = N <= 4 ? RING : 4;
  float ring[PF][N], mring[PF];
#pragma unroll
  for (int j = 0; j < PF; ++j) {
    const int t = T - 1 - j;
#pragma unroll
    for (int k = 0; k < N; ++k)
      ring[j][k] = (t >= 0 && in[k]) ? em[t * step + row + k] : 0.f;
    mring[j] = t >= 0 ? mask[(size_t)t * B + b] : 0.f;
  }
  for (int t0 = T - 1; t0 >= 0; t0 -= PF) {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int t = t0 - j;
      if (t < 0) break;                  // the same for the whole warp
      float e[N];
#pragma unroll
      for (int k = 0; k < N; ++k) e[k] = ring[j][k];
      const float m = mring[j];
      const int tn = t - PF;
      if (tn >= 0) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          if (in[k]) ring[j][k] = em[tn * step + row + k];
        mring[j] = mask[(size_t)tn * B + b];
      }
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (in[k]) betas[t * step + row + k] = beta[k];
      if (t > 0 && m > 0.f) {            // m is the same for the whole warp
        float be[N], bs[N];
#pragma unroll
        for (int k = 0; k < N; ++k) {
          be[k] = live[k] ? beta[k] + e[k] : NEG;
          bs[k] = can_skip[k] ? be[k] : NEG;
        }
        // the first states of lane l+1 (NEG right of the last state)
        float n0 = __shfl_down_sync(FULL, be[0], 1);
        float q0 = __shfl_down_sync(FULL, bs[0], 1);
        float q1 = __shfl_down_sync(FULL, bs[1], 1);
        if (lane == 31) n0 = q0 = q1 = NEG;
#pragma unroll
        for (int k = 0; k < N; ++k) {
          const float b1 = k + 1 < N ? be[k + 1] : n0;
          const float b2 = k + 2 < N    ? bs[k + 2]
                           : k + 2 == N ? q0
                                        : q1;
          const float v = lse3_top(be[k], b1, b2);
          beta[k] = live[k] ? fmaxf(v, NEG) : NEG;
        }
      }
    }
  }
}

// d_em = -exp(clip(alpha + beta - ll, -80, 0)) * m * ct[b] (ct absent:
// 1) at every (t, b, s) at once
__global__ void ctc_bwd_marginals_kernel(const float* __restrict__ alphas,
                                         const float* __restrict__ betas,
                                         const float* __restrict__ mask,
                                         const float* __restrict__ ll,
                                         const float* __restrict__ ct,
                                         float* __restrict__ d_em, int B,
                                         int T, int S) {
  const size_t n = (size_t)T * B * S;
  for (size_t x = (size_t)blockIdx.x * blockDim.x + threadIdx.x; x < n;
       x += (size_t)gridDim.x * blockDim.x) {
    const size_t tb = x / S;             // t B + b
    const int b = (int)(tb % B);
    const float c = ct ? ct[b] : 1.f;
    d_em[x] = -(expf(fminf(fmaxf(alphas[x] + betas[x] - ll[b], -80.f), 0.f)) *
                mask[tb] * c);
  }
}

// one warp a batch row: the alpha recursion into alphas, or (BACKWARD)
// the beta recursion from beta_init into betas
template <int N, bool BACKWARD>
cudaError_t launch(const float* em, const float* mask, const float* skip,
                   const float* ok, const float* beta_init, float* out,
                   int B, int T, int S, cudaStream_t st) {
  const dim3 grid((B + WARPS - 1) / WARPS), block(32 * WARPS);
  if constexpr (BACKWARD)
    ctc_bwd_kernel<N><<<grid, block, 0, st>>>(em, mask, skip, ok, beta_init,
                                              out, B, T, S);
  else
    ctc_fwd_kernel<N><<<grid, block, 0, st>>>(em, mask, skip, ok, out, B, T,
                                              S);
  return cudaGetLastError();
}

// launch<N, BACKWARD> at N = states_per_lane(S)
template <bool BACKWARD>
cudaError_t launch_recursion(const float* em, const float* mask,
                             const float* skip, const float* ok,
                             const float* beta_init, float* out, int B,
                             int T, int S, cudaStream_t st) {
  switch (S <= 512 ? states_per_lane(S) : 0) {
#define CTC_CASE(n)                                                       \
  case n:                                                                 \
    return launch<n, BACKWARD>(em, mask, skip, ok, beta_init, out, B, T, \
                               S, st);
    CTC_CASE(2) CTC_CASE(3) CTC_CASE(4) CTC_CASE(6) CTC_CASE(8) CTC_CASE(12)
    CTC_CASE(16)
#undef CTC_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launch on `stream` of the current device, one warp per batch row;
// return the cudaError_t of the launch (0 on success).
int ctc_fwd(const float* em, const float* mask, const float* skip,
            const float* ok, float* alphas, int B, int T, int S,
            void* stream) {
  return (int)launch_recursion<false>(em, mask, skip, ok, nullptr, alphas,
                                      B, T, S, (cudaStream_t)stream);
}

// The beta recursion: betas [T, B, S], one warp per batch row.
int ctc_bwd(const float* em, const float* mask, const float* skip,
            const float* ok, const float* beta_init, float* betas, int B,
            int T, int S, void* stream) {
  if (!beta_init) return (int)cudaErrorInvalidValue;
  return (int)launch_recursion<true>(em, mask, skip, ok, beta_init, betas, B,
                                     T, S, (cudaStream_t)stream);
}

// The posteriors from the alphas and the betas, times ct (null: 1): a
// grid of 256-thread blocks over the T B S entries, at most 8 an SM.
int ctc_bwd_marginals(const float* alphas, const float* betas,
                      const float* mask, const float* ll, const float* ct,
                      float* d_em, int B, int T, int S, void* stream) {
  const size_t n = (size_t)T * B * S;
  const int blocks = (int)std::min<size_t>((n + 255) / 256, 132 * 8);
  ctc_bwd_marginals_kernel<<<blocks, 256, 0, (cudaStream_t)stream>>>(
      alphas, betas, mask, ll, ct, d_em, B, T, S);
  return (int)cudaGetLastError();
}

const char* ctc_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* ctc_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* ctc_bwd_marginals_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
