// CTC forward-backward for Hopper (sm_90a): the alpha recursion and its
// backward over the blank-interleaved label states, bound to Python
// through ctypes.
//
// Replaces: paddle_tpu/kernels/ctc.py `_fwd_kernel` (launched by
// `_alphas`) and `_bwd_kernel` (launched by `_ctc_fb_bwd`), the Pallas TPU
// kernels that run the whole time loop of CTC's forward-backward with the
// [B, S] state resident in VMEM. Here that work is two kernels:
//   ctc_fwd  alphas [T, B, S] (one warp per batch row);
//   ctc_bwd  d_em [T, B, S], the negated posterior marginals (one warp per
//            batch row); the wrapper multiplies them by the cotangent.
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
// beta_init; ll = ll[b]):
//   d_em[t][s] = -(exp(clip(alpha_t[s] + beta[s] - ll, -80, 0)) * m)
//   be[s]      = ok[s] ? beta[s] + em[t][s] : NEG
//   beta[s]    = m > 0 ? (ok[s] ? max(lse3(be[s], be[s+1],
//                                          skip[s+2] ? be[s+2] : NEG), NEG)
//                                : NEG) : beta[s]   (NEG right of S-1)
// The s+2 term is taken where the TARGET state can skip. The beta of t=0
// is never read, so it is not computed. NEG, the -1e29 floor, the clamp
// at NEG and the -80 clip are the TPU kernels': every state stays finite,
// so a dead row never turns into 0 * -inf = NaN.
//
// Layout: time-major, as the TPU kernels': em, alphas and d_em [T, B, S],
// mask [T, B], skip, ok and beta_init [B, S] (1.0 / 0.0 flags; beta_init
// 0.0 at the terminal states, NEG elsewhere), ll [B]. All float32, all
// contiguous.
//
// Bound on an H100 SXM at T=512, B=32, S=41: each kernel reads em (2.7 MB)
// and writes a [T, B, S] output (2.7 MB), the backward reads the alphas
// as well; some 1.6 and 2.4 us at 3.35 TB/s. The arithmetic, four
// transcendentals and some ten flops a valid (row, step, state), is some
// 0.15 us at 67 TFLOP/s. Bytes bound both. The time loop is serial, a
// chain of T dependent steps of some 100 to 200 cycles each (two warp
// shuffles, three expf and a logf), so each kernel sits far above that
// bound.
//
// Design. On the TPU a step is a [B, S] tile shifted along its lanes; on
// Hopper every row's recursion is independent, so one warp owns a row and
// loops over T with no barrier at all. Lane l holds the 2K consecutive
// states from 2Kl (the blank 2Kl and what follows it) in registers, K the
// least of 1, 2, 4 and 8 that covers S (K=1 covers 64 states: U <= 31).
// State s needs s-1 and s-2, so a forward step takes the last two states
// of lane l-1 by two __shfl_up_sync; a backward step takes be and the
// skip-filtered be of the first states of lane l+1 by three
// __shfl_down_sync. em (and, backward, the alphas) do not depend on the
// recursion, so each lane keeps a ring of the next PF steps' values in
// registers, loaded PF steps ahead, and the load latency stays off the
// serial chain. WARPS rows share a block: B=32 rows give 8 blocks on 132
// SMs, one warp on each of an SM's four schedulers. There is no shared
// memory, so the kernels take any B, and S up to 512 (K=8: 16 states, 64
// ring values and their flags a lane, in registers; ptxas gives the
// forward 64, 80, 128 and 168 registers for K = 1, 2, 4, 8 and the
// backward 56, 95, 149 and 255, the K=8 backward spilling 64 bytes).
// expf and logf are the accurate ones: the build has no fast-math flag.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 4;   // rows per block
constexpr int PF = 4;      // steps loaded ahead

__device__ __forceinline__ float lse3(float x, float y, float z) {
  const float mx = fmaxf(fmaxf(x, y), z);
  const float ms = fmaxf(mx, -1e29f);
  return mx + logf(expf(x - ms) + expf(y - ms) + expf(z - ms));
}

// the least K (2K states a lane) that covers S states, 0 beyond 512
int k_for(int S) {
  if (S <= 64) return 1;
  if (S <= 128) return 2;
  if (S <= 256) return 4;
  if (S <= 512) return 8;
  return 0;
}

template <int K>
__global__ void __launch_bounds__(32 * WARPS)
ctc_fwd_kernel(const float* __restrict__ em, const float* __restrict__ mask,
               const float* __restrict__ skip, const float* __restrict__ ok,
               float* __restrict__ alphas, int B, int T, int S) {
  constexpr int N = 2 * K;
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
          const float v = lse3(a[k], a1, a2) + e[k];
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

template <int K>
__global__ void __launch_bounds__(32 * WARPS)
ctc_bwd_kernel(const float* __restrict__ em, const float* __restrict__ mask,
               const float* __restrict__ skip, const float* __restrict__ ok,
               const float* __restrict__ beta_init,
               const float* __restrict__ alphas,
               const float* __restrict__ ll, float* __restrict__ d_em, int B,
               int T, int S) {
  constexpr int N = 2 * K;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (b >= B) return;
  const int s0 = lane * N;
  const size_t row = (size_t)b * S + s0;
  const size_t step = (size_t)B * S;
  const float lz = ll[b];

  bool in[N], live[N], can_skip[N];
  float beta[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    in[k] = s0 + k < S;
    live[k] = in[k] && ok[row + k] > 0.f;
    can_skip[k] = in[k] && skip[row + k] > 0.f;
    beta[k] = in[k] ? beta_init[row + k] : NEG;
  }

  // ring[j]: the emissions, alphas and mask of a step to come, PF ahead
  float ering[PF][N], aring[PF][N], mring[PF];
#pragma unroll
  for (int j = 0; j < PF; ++j) {
    const int t = T - 1 - j;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      ering[j][k] = (t >= 0 && in[k]) ? em[t * step + row + k] : 0.f;
      aring[j][k] = (t >= 0 && in[k]) ? alphas[t * step + row + k] : 0.f;
    }
    mring[j] = t >= 0 ? mask[(size_t)t * B + b] : 0.f;
  }
  for (int t0 = T - 1; t0 >= 0; t0 -= PF) {
#pragma unroll
    for (int j = 0; j < PF; ++j) {
      const int t = t0 - j;
      if (t < 0) break;                  // the same for the whole warp
      float e[N], al[N];
#pragma unroll
      for (int k = 0; k < N; ++k) {
        e[k] = ering[j][k];
        al[k] = aring[j][k];
      }
      const float m = mring[j];
      const int tn = t - PF;
      if (tn >= 0) {
#pragma unroll
        for (int k = 0; k < N; ++k)
          if (in[k]) {
            ering[j][k] = em[tn * step + row + k];
            aring[j][k] = alphas[tn * step + row + k];
          }
        mring[j] = mask[(size_t)tn * B + b];
      }
      // the posterior at t, from beta before it is folded with em[t]
#pragma unroll
      for (int k = 0; k < N; ++k)
        if (in[k])
          d_em[t * step + row + k] =
              -(expf(fminf(fmaxf(al[k] + beta[k] - lz, -80.f), 0.f)) * m);
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
          const float v = lse3(be[k], b1, b2);
          beta[k] = live[k] ? fmaxf(v, NEG) : NEG;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// Launch on `stream` of the current device, one warp per batch row;
// return the cudaError_t of the launch (0 on success).
int ctc_fwd(const float* em, const float* mask, const float* skip,
            const float* ok, float* alphas, int B, int T, int S,
            void* stream) {
  const dim3 grid((B + WARPS - 1) / WARPS), block(32 * WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (k_for(S)) {
    case 1: ctc_fwd_kernel<1><<<grid, block, 0, st>>>(em, mask, skip, ok,
                                                      alphas, B, T, S); break;
    case 2: ctc_fwd_kernel<2><<<grid, block, 0, st>>>(em, mask, skip, ok,
                                                      alphas, B, T, S); break;
    case 4: ctc_fwd_kernel<4><<<grid, block, 0, st>>>(em, mask, skip, ok,
                                                      alphas, B, T, S); break;
    case 8: ctc_fwd_kernel<8><<<grid, block, 0, st>>>(em, mask, skip, ok,
                                                      alphas, B, T, S); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int ctc_bwd(const float* em, const float* mask, const float* skip,
            const float* ok, const float* beta_init, const float* alphas,
            const float* ll, float* d_em, int B, int T, int S, void* stream) {
  const dim3 grid((B + WARPS - 1) / WARPS), block(32 * WARPS);
  cudaStream_t st = (cudaStream_t)stream;
  switch (k_for(S)) {
    case 1: ctc_bwd_kernel<1><<<grid, block, 0, st>>>(
        em, mask, skip, ok, beta_init, alphas, ll, d_em, B, T, S); break;
    case 2: ctc_bwd_kernel<2><<<grid, block, 0, st>>>(
        em, mask, skip, ok, beta_init, alphas, ll, d_em, B, T, S); break;
    case 4: ctc_bwd_kernel<4><<<grid, block, 0, st>>>(
        em, mask, skip, ok, beta_init, alphas, ll, d_em, B, T, S); break;
    case 8: ctc_bwd_kernel<8><<<grid, block, 0, st>>>(
        em, mask, skip, ok, beta_init, alphas, ll, d_em, B, T, S); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* ctc_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* ctc_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
