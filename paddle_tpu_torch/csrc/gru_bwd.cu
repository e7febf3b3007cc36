// Fused GRU backward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/gru.py `_bwd_kernel` (launched by
// `_bwd_call`), the Pallas TPU kernel that walks the GRU recurrence in
// reverse over the forward's z|r|c stash and accumulates dWg, dWc and the
// bias gradient in the kernel. Here that work is the recurrence, then dW
// and a sum:
//   gru_bwd_cluster    the reverse recurrence: dx3 = [dz_pre | dr_pre |
//   or gru_bwd         dc_pre]; kernels/gru.py gru_bwd_plan picks one of
//                      the two kernels from (B, H) alone;
//   gru_bwd_dw         dWg, dWc and db from dx3, the stash and hs, launched
//                      once after it (a reduction over every (row, step)
//                      pair; dx3 is zero at padded steps, so they add
//                      nothing), the pairs split S ways;
//   gru_bwd_dw_reduce  where S > 1, the S partials summed in split order.
//
// What it computes, per step t from T-1 down to 0 (m = mask[b, t],
// h_prev = (1 - reset[b, t]) * hs[b, t-1], zero at t = 0):
//   dh_t   = g_hs[t] + dh                            (dh: the carry)
//   dh_new = m*dh_t, dh_pass = (1-m)*dh_t
//   dc_pre = dh_new*(1-z)*(1-c^2)
//   dz_pre = dh_new*(h_prev-c)*z*(1-z)
//   drh    = dc_pre @ Wc^T
//   dr_pre = drh*h_prev*r*(1-r)
//   dh     = dh_new*z + dh_pass + drh*r + [dz_pre | dr_pre] @ Wg^T,
//            times (1 - reset[b, t]) when there is a reset vector
// and gru_bwd_dw forms dWg = sum h_prev^T [dz_pre | dr_pre],
// dWc = sum (r*h_prev)^T dc_pre and db = sum dx3 over every (row, step).
// dx3 is written at every step, padded ones too; its dr_pre column is zero
// at t = 0.
//
// Layout: batch-major, as the forward: gates [B, T, 3H] (post-activation
// z, r, c, written by gru_fwd at every step, padded ones too), hs and g_hs
// [B, T, H], mask and reset [B, T] (reset may be NULL), Wg [H, 2H], Wc
// [H, H]; out dx3 [B, T, 3H], dWg [H, 2H], dWc [H, H], db [3H]. All
// float32, all contiguous.
//
// Bound on an H100 SXM at B=64, T=100, H=512, every step valid: the two
// dh products are 2*B*T*(H*H + 2H*H) flops (10.1 GFLOP), 0.15 ms on the
// float32 CUDA cores at 67 TFLOP/s; the dW products as much again, which
// gru_bwd_dw runs on the tensor cores in three TF32 passes, 30.2 GFLOP,
// 0.061 ms at 495 TFLOP/s. The bytes (stash, dx3, hs, g_hs: 8H floats per
// (row, step), about 105 MB) take about 0.03 ms at 3.35 TB/s. So
// operations bound both, and the time loop of the recurrence is serial:
// each step needs all of step t+1's dh. A step is latency, a chain of two
// dependent exchanges between the blocks: drh needs all of dc_pre, and
// dg's dr_pre half needs drh.
//
// Both recurrence kernels split the weights across blocks by hidden unit:
// a block keeps the ROWS of Wc and Wg for its units in shared memory,
// because both dh products contract over the gate columns: drh[b, u] =
// dc_pre[b, :] . Wc[u, :] and the same with dg and Wg. The dh carry of a
// block's own units never leaves the block. Each step has three phases:
//   (1) local: dc_pre and dz_pre of the block's units from the stash and
//       the carry;
//   exchange
//   (2) drh (then dr_pre) and the dz half of the dh product, dz_pre @
//       Wg[:, :H]^T: both inputs are complete after the first exchange;
//   exchange
//   (3) the dr half, dr_pre @ Wg[:, H:]^T, into the carry, gated by the
//       reset.
// At t = 0 phases 2 and 3 are skipped: h_prev is zero there, so dr_pre is
// zero and the carry is not needed.
//
// The cluster path (gru_bwd_cluster_kernel), where the weights and the
// rows fit a thread-block cluster (the RNN CRF tagger's H = 128 among
// them), as the forward's: clusters of C <= 16 blocks (cudaLaunchKernelEx
// with a cluster dimension; above 8 the non-portable size), ceil(B / R)
// clusters, each owning R batch rows; block j of a cluster owns U = H / C
// units and keeps Wc[u, :] and Wg[u, :] of them, k-major ([H][U] and
// [2H][U]: 24 KB at H = 128, C = 8). Every block holds the cluster's R rows
// of dc_pre and dz_pre ([H][2R], the two of one k side by side) and of
// dr_pre ([H][R]) for all H units. An exchange writes the block's units'
// run (2UR floats after phase 1, UR after phase 2) into its own copy and,
// 16 bytes a store, into the other C - 1 blocks' through distributed
// shared memory, then meets them at a cluster barrier. Each barrier is
// split: arrive after the exchange, then the step's dx3 stores from
// registers (and after the first, the cp.async copies of step t-2's
// inputs), then wait: a barrier's release waits for every store before
// it. No global memory is on a step's path: g_hs, z, r, c and hs[t-1] of
// the block's units, the mask and the reset of its R rows come through a
// ring of 3 steps in shared memory. The products stay float32 FMA: 256
// threads, each a (column c, k-part p) pair of 256/U parts, hold R (in
// phase 2, 2R) independent sums over k = p, p + parts, ...; the parts' sums
// are added in part order by the thread that owns the (row, unit), the
// thread that holds its carry in registers. No atomics: two launches give
// the same bits.
//
// The grid path (gru_bwd_kernel), for the rest (the NMT encoder's H = 512:
// 3 MiB of weights do not fit a cluster): block j owns hidden units [4j,
// 4j+4) and keeps their rows, Wc's 4 (4 x H) and Wg's (4 x 2H), 24 KB at
// H=512, and the carry of every batch row ([B][4]); the phases are closed
// by grid barriers (grid.sync()) and exchange through dx3 in device memory:
// phase 1 writes dc_pre and dz_pre, phase 2 dr_pre, and phases 2 and 3
// stage the rows they need, 16 of them a tile ([16][H]: dc_pre then dz_pre
// of each row tile in phase 2, dr_pre in phase 3), through two stages: tile
// i + 1's cp.async copies are in flight during tile i's products. dx3
// written by other blocks during the launch is staged with cp.async.cg (L2
// only), never through a possibly stale L1 line. The inputs of a tile's
// epilogue (r, hs[t-1] and the reset of its rows) are loaded before its
// product; phase 1's (g_hs, the stash, hs, mask and reset of the thread's
// first 4 (row, unit) items) are loaded for step t-1 at the start of
// step t's phase 3. The launch is cooperative: H/4 blocks that must all be
// resident (about 89 KB of shared memory each at H=512, 128 blocks on 132
// SMs); the wrapper asks gru_bwd_max_coresident_blocks(B, H) and raises
// when they do not fit.
//
// Design of gru_bwd_dw. A product whose depth is the pairs: [dWg | dWc]
// [H, 3H] = A^T D summed over the B*T (row, step) pairs, on the tensor
// cores as mma.sync m16n8k8 with TF32 operands in three passes (each
// operand split a = big + small, big its top 10 mantissa bits and small
// the rest; big·small + small·big + big·big keep float32's accuracy, as
// in csrc/vocab_xent.cu's dW and dx). A block of 4 warps owns a 64 x 64
// tile of one part (rows k, columns j), a 32 x 32 quarter a warp, and
// walks its split's pairs in chunks of 32: h_prev's rows (hs row n - 1,
// zero-filled at a row's first step), r's rows for dWc and dx3's columns
// stream by 16-byte cp.async through two stages; A = h_prev * (1 -
// reset), times r for dWc, is formed in float32 as the fragments are read
// (the fusion a library product cannot do: the plain version writes r *
// h_prev out). Each chunk's sum forms in fresh accumulators and is added
// in float32: the tensor cores truncate every MMA's float32 sum. The
// blocks of the first k tile also sum db's columns. The pairs are split S
// ways over the grid's third dimension, S chosen by the wrapper from the
// shape so that some 2 blocks an SM run (12 tiles x S at H = 128, 192 x S
// at H = 512): with S = 1 a block writes the outputs, else its split's
// partial, and gru_bwd_dw_reduce sums the partials in split order. Every
// sum runs in a fixed order: no atomics, the same bits in every run.
// Staged rows are 72 floats apart (8 mod 32), so every fragment read hits
// 32 distinct banks.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dw_tf32.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

// --- the grid path ----------------------------------------------------------

constexpr int U = 4;                    // hidden units per block
constexpr int THREADS = 256;
constexpr int ROWS = 16;                // batch rows per staged tile
constexpr int KSPLIT = THREADS / ROWS;  // lanes per row in the products
constexpr int PF = 4;                   // phase-1 items a thread prefetches
static_assert(KSPLIT == 16, "the shuffle reduction below sums 16 lanes");

// shared memory, in floats: Wc rows [U][H+4], Wg rows [U][2H+4], two tile
// stages [ROWS][H] (a quarter-warp reads 8 consecutive float4 of one row,
// so the rows need no pad), the dh carry [B][U]
size_t smem_floats(int B, int H) {
  return (size_t)U * (H + 4) + (size_t)U * (2 * H + 4) +
         (size_t)2 * ROWS * H + (size_t)B * U;
}

size_t smem_bytes(int B, int H) { return sizeof(float) * smem_floats(B, H); }

// H columns of dx3 [B, T, 3H] from col0, rows [b0, b0+nrows) at step t,
// into a tile [ROWS][H]: every thread starts its 16-byte copies and does
// not wait for them
__device__ __forceinline__ void stage_tile(float* tile, const float* dx3,
                                           int b0, int nrows, int t, int T,
                                           int H, int col0) {
  const int H_4 = H / 4;
  const size_t H3 = 3 * (size_t)H;
  for (int i = threadIdx.x; i < nrows * H_4; i += THREADS) {
    const int r = i / H_4, k4 = i % H_4;
    const size_t bt = (size_t)(b0 + r) * T + t;
    cp_async16(tile + r * H + 4 * k4, dx3 + bt * H3 + col0 + 4 * k4);
  }
}

// the 4 units' products of tile row d_r (width floats) with the weight
// rows w_s (pitch ldw): lane d_split of the row's 16 sums every 16th
// float4, then a shuffle reduction leaves the full sums in every lane.
// Every thread of the block calls it (the shuffles need whole warps).
__device__ __forceinline__ void row_products(const float* tile, int ldt,
                                             const float* w_s, int ldw,
                                             int width, int d_r,
                                             int d_split, int nrows,
                                             float acc[U]) {
#pragma unroll
  for (int uu = 0; uu < U; ++uu) acc[uu] = 0.f;
  if (d_r < nrows) {
    const float4* prow = reinterpret_cast<const float4*>(tile + d_r * ldt);
    for (int k4 = d_split; k4 < width / 4; k4 += KSPLIT) {
      const float4 p = prow[k4];
#pragma unroll
      for (int uu = 0; uu < U; ++uu) {
        const float4 q = reinterpret_cast<const float4*>(w_s + uu * ldw)[k4];
        acc[uu] = fmaf(p.x, q.x, acc[uu]);
        acc[uu] = fmaf(p.y, q.y, acc[uu]);
        acc[uu] = fmaf(p.z, q.z, acc[uu]);
        acc[uu] = fmaf(p.w, q.w, acc[uu]);
      }
    }
  }
#pragma unroll
  for (int uu = 0; uu < U; ++uu)
#pragma unroll
    for (int o = 1; o < KSPLIT; o <<= 1)
      acc[uu] += __shfl_xor_sync(0xffffffffu, acc[uu], o);
}

__device__ __forceinline__ float pick(const float acc[U], int uu) {
  return uu == 0 ? acc[0] : uu == 1 ? acc[1] : uu == 2 ? acc[2] : acc[3];
}

// h_prev as the forward's cell consumed it: zero at t = 0, gated by the
// reset of step t
__device__ __forceinline__ float prev_state(const float* hs,
                                            const float* reset, size_t bt,
                                            int t, int H, int j) {
  if (t == 0) return 0.f;
  float h = hs[(bt - 1) * H + j];
  if (reset != nullptr) h *= 1.f - reset[bt];
  return h;
}

// phase 1's inputs of one (row, unit) item at a step
struct StepIn {
  float g, z, c, h_prev, m;
};

__device__ __forceinline__ StepIn step_inputs(
    const float* __restrict__ mask, const float* __restrict__ reset,
    const float* __restrict__ gates, const float* __restrict__ hs,
    const float* __restrict__ g_hs, int i, int t, int T, int H, int u0) {
  const int b = i / U, j = u0 + i % U;
  const size_t bt = (size_t)b * T + t;
  const float* g = gates + bt * 3 * (size_t)H;
  return StepIn{g_hs[bt * H + j], g[j], g[2 * H + j],
                prev_state(hs, reset, bt, t, H, j), mask[bt]};
}

__global__ void __launch_bounds__(THREADS)
gru_bwd_kernel(const float* __restrict__ wg, const float* __restrict__ wc,
               const float* __restrict__ mask,
               const float* __restrict__ reset,
               const float* __restrict__ gates,
               const float* __restrict__ hs,
               const float* __restrict__ g_hs, float* dx3, int B, int T,
               int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int LDC = H + 4;
  const int LDG = 2 * H + 4;
  float* wc_s = smem;                   // wc_s[uu*LDC + k] = Wc[u0+uu, k]
  float* wg_s = wc_s + U * LDC;         // wg_s[uu*LDG + k] = Wg[u0+uu, k]
  float* tiles = wg_s + U * LDG;        // two stages [ROWS][H]
  float* dh_s = tiles + 2 * ROWS * H;   // dh carry [B][U]

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const size_t H3 = 3 * (size_t)H;
  const int items = B * U;              // phase 1's (row, unit) items
  const int nblk = (B + ROWS - 1) / ROWS;

  const int H_4 = H / 4, H2_4 = H / 2;
  for (int i = tid; i < U * H_4; i += THREADS) {
    const int uu = i / H_4, k4 = i % H_4;
    reinterpret_cast<float4*>(wc_s + uu * LDC)[k4] =
        reinterpret_cast<const float4*>(wc + (size_t)(u0 + uu) * H)[k4];
  }
  for (int i = tid; i < U * H2_4; i += THREADS) {
    const int uu = i / H2_4, k4 = i % H2_4;
    reinterpret_cast<float4*>(wg_s + uu * LDG)[k4] =
        reinterpret_cast<const float4*>(wg + (size_t)(u0 + uu) * 2 * H)[k4];
  }
  for (int i = tid; i < items; i += THREADS) dh_s[i] = 0.f;
  // the products: KSPLIT adjacent lanes per tile row
  const int d_r = tid / KSPLIT, d_split = tid % KSPLIT;
  const bool owner = d_split < U;       // holds a (tile row, unit) output
  // phase 1's inputs of the thread's first PF items, a step ahead
  StepIn pre[PF];
#pragma unroll
  for (int n = 0; n < PF; ++n)
    if (tid + n * THREADS < items)
      pre[n] = step_inputs(mask, reset, gates, hs, g_hs, tid + n * THREADS,
                           T - 1, T, H, u0);
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // ---- phase 1: dc_pre and dz_pre of this block's units, one thread
    //      per (row, unit)
    auto local = [&](int i, const StepIn& s) {
      const int b = i / U, j = u0 + i % U;
      const float dh_t = s.g + dh_s[i];
      const float dh_new = s.m * dh_t;
      float* out = dx3 + ((size_t)b * T + t) * H3;
      out[j] = dh_new * (s.h_prev - s.c) * s.z * (1.f - s.z);
      out[2 * H + j] = dh_new * (1.f - s.z) * (1.f - s.c * s.c);
      if (t == 0) out[H + j] = 0.f;     // dr_pre: h_prev is zero
      dh_s[i] = dh_new * s.z + (1.f - s.m) * dh_t;
    };
#pragma unroll
    for (int n = 0; n < PF; ++n)
      if (tid + n * THREADS < items) local(tid + n * THREADS, pre[n]);
    for (int i = tid + PF * THREADS; i < items; i += THREADS)
      local(i, step_inputs(mask, reset, gates, hs, g_hs, i, t, T, H, u0));
    if (t == 0) break;
    grid.sync();        // all of dc_pre, dz_pre[:, t] written

    // ---- phase 2: per row tile, drh = dc_pre @ Wc^T for this block's
    //      units (then dr_pre, and drh*r into the carry), then dz_pre @
    //      Wg[:, :H]^T into the carry: tile i is row tile i/2's dc_pre
    //      (i even, stage 0) or dz_pre (i odd, stage 1)
    stage_tile(tiles, dx3, 0, min(ROWS, B), t, T, H, 2 * H);
    cp_async_commit();
    for (int i = 0; i < 2 * nblk; ++i) {
      const int b0 = (i >> 1) * ROWS, nrows = min(ROWS, B - b0);
      const bool dc = (i & 1) == 0;
      if (i + 1 < 2 * nblk) {
        const int b1 = ((i + 1) >> 1) * ROWS;
        stage_tile(tiles + ((i + 1) & 1) * ROWS * H, dx3, b1,
                   min(ROWS, B - b1), t, T, H, dc ? 0 : 2 * H);
      }
      cp_async_commit();
      // the epilogue's inputs, in flight during the product
      float r = 0.f, h_prev = 0.f;
      const bool out = owner && d_r < nrows;
      if (dc && out) {
        const size_t bt = (size_t)(b0 + d_r) * T + t;
        r = gates[bt * H3 + H + u0 + d_split];
        h_prev = prev_state(hs, reset, bt, t, H, u0 + d_split);
      }
      cp_async_wait<1>();  // tile i has landed (this thread's copies)
      __syncthreads();     // ... everyone's
      float acc[U];
      row_products(tiles + (i & 1) * ROWS * H, H, dc ? wc_s : wg_s,
                   dc ? LDC : LDG, H, d_r, d_split, nrows, acc);
      if (out) {
        const int b = b0 + d_r;
        const float p = pick(acc, d_split);
        if (dc) {
          const size_t bt = (size_t)b * T + t;
          dx3[bt * H3 + H + u0 + d_split] = p * h_prev * r * (1.f - r);
          dh_s[b * U + d_split] += p * r;
        } else {
          dh_s[b * U + d_split] += p;
        }
      }
      __syncthreads();     // the stage takes tile i + 2
    }
    grid.sync();        // all of dr_pre[:, t] written

    // ---- phase 3: step t-1's phase-1 inputs, in flight during the phase;
    //      per row tile, dh += dr_pre @ Wg[:, H:]^T, gated by the reset
#pragma unroll
    for (int n = 0; n < PF; ++n)
      if (tid + n * THREADS < items)
        pre[n] = step_inputs(mask, reset, gates, hs, g_hs, tid + n * THREADS,
                             t - 1, T, H, u0);
    stage_tile(tiles, dx3, 0, min(ROWS, B), t, T, H, H);
    cp_async_commit();
    for (int i = 0; i < nblk; ++i) {
      const int b0 = i * ROWS, nrows = min(ROWS, B - b0);
      if (i + 1 < nblk)
        stage_tile(tiles + ((i + 1) & 1) * ROWS * H, dx3, b0 + ROWS,
                   min(ROWS, B - b0 - ROWS), t, T, H, H);
      cp_async_commit();
      float keep = 1.f;
      const bool out = owner && d_r < nrows;
      if (out && reset != nullptr)
        keep = 1.f - reset[(size_t)(b0 + d_r) * T + t];
      cp_async_wait<1>();
      __syncthreads();
      float acc[U];
      row_products(tiles + (i & 1) * ROWS * H, H, wg_s + H, LDG, H, d_r,
                   d_split, nrows, acc);
      if (out) {
        const int b = b0 + d_r;
        dh_s[b * U + d_split] = (dh_s[b * U + d_split] + pick(acc, d_split))
                                * keep;
      }
      __syncthreads();  // the stage is refilled; the carry read next step
    }
  }
}

// --- the cluster path -------------------------------------------------------

constexpr int CL_THREADS = 256;
constexpr int CL_MAX_BLOCKS = 16;  // blocks a cluster (above 8 non-portable)
constexpr int CL_NS = 3;           // steps of the input ring
constexpr int CL_IN = 5;  // ring columns a unit: g_hs, z, r, c, hs[t-1]

// shared memory of a cluster block for hidden size H, C blocks a cluster
// and R rows a cluster (U = H / C units a block): Wc's and Wg's rows of
// its units k-major [H][U] and [2H][U]; the R rows' dc_pre and dz_pre
// [H][2R] and dr_pre [H][R]; the k-parts' sums, two of [256/U][R][U]; the
// ring of CL_NS steps: the units' inputs [R][5U], then the mask and reset
// [R] of every step; every region a multiple of 16 bytes
size_t cluster_smem_bytes(int H, int C, int R) {
  const size_t U = H / C;
  return sizeof(float) * (3 * U * H + 3 * (size_t)H * R
                          + 2 * (size_t)CL_THREADS * R
                          + CL_NS * (CL_IN * U * R + 2 * (size_t)R));
}

// grid (C, ceil(B / R)), clusters of (C, 1, 1): cluster y owns batch rows
// [yR, yR + R), its block j hidden units [jU, jU + U). See the note at the
// top of the file.
template <int R>
__global__ void __launch_bounds__(CL_THREADS, 1)
gru_bwd_cluster_kernel(const float* __restrict__ wg,
                       const float* __restrict__ wc,
                       const float* __restrict__ mask,
                       const float* __restrict__ reset,
                       const float* __restrict__ gates,
                       const float* __restrict__ hs,
                       const float* __restrict__ g_hs,
                       float* __restrict__ dx3, int B, int T, int H,
                       bool vec) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, U = H / C, KP = CL_THREADS / U;
  const int u0 = blockIdx.x * U, b0 = blockIdx.y * R;
  const int tid = threadIdx.x;
  const size_t H3 = 3 * (size_t)H;
  const int XU = CL_IN * U;       // ring floats a row
  float* wct = smem;              // [H][U]: Wc[u0 + c, k]
  float* wgt = wct + H * U;       // [2H][U]: Wg[u0 + c, k]
  float* dcz = wgt + 2 * H * U;   // [H][2R]: dc_pre, then dz_pre, of a k
  float* drs = dcz + 2 * H * R;   // [H][R]: dr_pre
  float* ps1 = drs + H * R;       // [KP][R][U]: drh, then the dr half
  float* ps2 = ps1 + CL_THREADS * R;     // [KP][R][U]: the dz half
  float* xring = ps2 + CL_THREADS * R;   // [CL_NS][R][5U]
  float* mring = xring + CL_NS * R * XU;  // [CL_NS][R]
  float* rring = mring + CL_NS * R;       // [CL_NS][R]

  for (int i = tid; i < U * H; i += CL_THREADS)
    wct[(i % H) * U + i / H] = wc[(size_t)(u0 + i / H) * H + i % H];
  for (int i = tid; i < U * 2 * H; i += CL_THREADS)
    wgt[(i % (2 * H)) * U + i / (2 * H)] =
        wg[(size_t)(u0 + i / (2 * H)) * 2 * H + i % (2 * H)];

  // step t's inputs into ring stage t % CL_NS: for the cluster's rows (rows
  // >= B read as 0), g_hs, z, r, c and hs[t-1] (zero at t = 0) of the
  // block's units, the mask and the reset
  auto prefetch = [&](int t) {
    float* xs = xring + (t % CL_NS) * R * XU;
    auto src = [&](int r, int q, bool& ok) -> const float* {
      const int part = q / U, off = u0 + q % U;
      const size_t bt = (size_t)(b0 + r) * T + t;
      ok = b0 + r < B && (part < 4 || t > 0);
      if (!ok) return g_hs;
      if (part == 0) return g_hs + bt * H + off;
      if (part < 4) return gates + bt * H3 + (part - 1) * H + off;
      return hs + (bt - 1) * H + off;
    };
    if (vec) {
      const int n4 = XU / 4;
      for (int i = tid; i < R * n4; i += CL_THREADS) {
        const int r = i / n4, q = i % n4 * 4;
        bool ok;
        const float* s = src(r, q, ok);
        cp_async16(xs + r * XU + q, s, ok);
      }
    } else {
      for (int i = tid; i < R * XU; i += CL_THREADS) {
        bool ok;
        const float* s = src(i / XU, i % XU, ok);
        cp_async4(xs + i, s, ok);
      }
    }
    if (tid < R) {
      const bool ok = b0 + tid < B;
      const size_t bt = (size_t)(b0 + tid) * T + t;
      cp_async4(mring + (t % CL_NS) * R + tid, ok ? mask + bt : mask, ok);
      if (reset != nullptr)
        cp_async4(rring + (t % CL_NS) * R + tid, ok ? reset + bt : reset, ok);
    }
  };
#pragma unroll
  for (int q = 0; q < CL_NS - 1; ++q) {
    if (T - 1 - q >= 0) prefetch(T - 1 - q);
    cp_async_commit();
  }
  cp_async_wait<CL_NS - 2>();  // step T-1's inputs (this thread's copies)
  // every block of the cluster has started and holds its weights before
  // any block writes into another's shared memory
  cluster.sync();

  // thread (c, p): column c of the products' k-part p; it owns unit c of
  // rows p, p + KP, ... and holds their carry
  const int c = tid % U, p = tid / U;
  float carry[R], part[R], pz[R];
#pragma unroll
  for (int j = 0; j < R; ++j) carry[j] = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const float* xs = xring + (t % CL_NS) * R * XU;
    const float* ms = mring + (t % CL_NS) * R;
    const float* rs = rring + (t % CL_NS) * R;
    auto keep = [&](int r) { return reset != nullptr ? 1.f - rs[r] : 1.f; };
    auto dx3_at = [&](int r) { return dx3 + ((size_t)(b0 + r) * T + t) * H3; };

    // ---- phase 1: dc_pre and dz_pre of the block's units, to every block
    float vz[R], vc[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = p + j * KP;
      if (r >= R) break;
      const float* x = xs + r * XU;
      const float z = x[U + c], cc = x[3 * U + c];
      const float h_prev = x[4 * U + c] * keep(r);
      const float m = ms[r];
      const float dh_t = x[c] + carry[j];
      const float dh_new = m * dh_t;
      vz[j] = dh_new * (h_prev - cc) * z * (1.f - z);
      vc[j] = dh_new * (1.f - z) * (1.f - cc * cc);
      part[j] = dh_new * z + (1.f - m) * dh_t;
      dcz[(u0 + c) * 2 * R + r] = vc[j];
      dcz[(u0 + c) * 2 * R + R + r] = vz[j];
    }
    if (t == 0) {  // h_prev is zero: dr_pre too, and no carry is needed
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = p + j * KP;
        if (r >= R) break;
        if (b0 + r >= B) continue;
        float* o = dx3_at(r);
        o[u0 + c] = vz[j];
        o[H + u0 + c] = 0.f;
        o[2 * H + u0 + c] = vc[j];
      }
      break;
    }
    __syncthreads();
    share_slice<CL_THREADS>(cluster, dcz, u0 * 2 * R, 2 * U * R);
    cluster_arrive();
    // during the barrier: dx3's z and c columns, and the copies of step
    // t-2's inputs into the ring stage that step t+1 read
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = p + j * KP;
      if (r >= R) break;
      if (b0 + r >= B) continue;
      float* o = dx3_at(r);
      o[u0 + c] = vz[j];
      o[2 * H + u0 + c] = vc[j];
    }
    if (t - (CL_NS - 1) >= 0) prefetch(t - (CL_NS - 1));
    cp_async_commit();
    cluster_wait();  // all of dc_pre and dz_pre is in every block

    // ---- phase 2: drh = dc_pre @ Wc^T and the dz half dz_pre @ Wg[:, :H]^T
    //      of the block's units; dr_pre to every block
    {
      float a1[R], a2[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a1[r] = a2[r] = 0.f;
      for (int k = p; k < H; k += KP) {
        rows_fma<R>(a1, dcz + k * 2 * R, wct[k * U + c]);
        rows_fma<R>(a2, dcz + k * 2 * R + R, wgt[k * U + c]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        ps1[(p * R + r) * U + c] = a1[r];
        ps2[(p * R + r) * U + c] = a2[r];
      }
    }
    __syncthreads();
    float vr[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = p + j * KP;
      if (r >= R) break;
      float drh = 0.f, dzh = 0.f;
      for (int q = 0; q < KP; ++q) {
        drh += ps1[(q * R + r) * U + c];
        dzh += ps2[(q * R + r) * U + c];
      }
      const float* x = xs + r * XU;
      const float rg = x[2 * U + c];
      const float h_prev = x[4 * U + c] * keep(r);
      vr[j] = drh * h_prev * rg * (1.f - rg);
      part[j] += drh * rg;
      pz[j] = dzh;
      drs[(u0 + c) * R + r] = vr[j];
    }
    __syncthreads();
    share_slice<CL_THREADS>(cluster, drs, u0 * R, U * R);
    cp_async_wait<CL_NS - 2>();  // step t-1's inputs (this thread's copies)
    cluster_arrive();
#pragma unroll
    for (int j = 0; j < R; ++j) {  // during the barrier: dx3's r column
      const int r = p + j * KP;
      if (r >= R) break;
      if (b0 + r < B) dx3_at(r)[H + u0 + c] = vr[j];
    }
    cluster_wait();  // all of dr_pre is in every block; step t-1's inputs

    // ---- phase 3: the dr half dr_pre @ Wg[:, H:]^T into the carry, gated
    //      by the reset
    {
      float a3[R];
#pragma unroll
      for (int r = 0; r < R; ++r) a3[r] = 0.f;
      for (int k = p; k < H; k += KP)
        rows_fma<R>(a3, drs + k * R, wgt[(H + k) * U + c]);
#pragma unroll
      for (int r = 0; r < R; ++r) ps1[(p * R + r) * U + c] = a3[r];
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = p + j * KP;
      if (r >= R) break;
      float drh2 = 0.f;
      for (int q = 0; q < KP; ++q) drh2 += ps1[(q * R + r) * U + c];
      carry[j] = (part[j] + (pz[j] + drh2)) * keep(r);
    }
  }
}

// ---- gru_bwd_dw: 3xTF32 mma.sync, the pair reduction split over the grid --
// (the tile, stage and chunk product of csrc/dw_tf32.cuh)

// Start the copies of chunk c (pairs n = c*DW_CH + row) into stage `st`:
// the rows of h_prev, hs row n - 1, zero-filled at a row's first step (n %
// T == 0) and past N; for dWc r = gates[n, H + k] beside them; dx3's
// columns of the tile (from dcol, `jok` when the thread's 4 lie inside the
// part); reset[n]. Thread tid copies columns 4 * (tid % 16) of rows tid /
// 16 + 8i, whose n % T it keeps in tq[i], advanced here to the next chunk.
template <bool CAND, bool RESET>
__device__ __forceinline__ void dw_stage(
    const float* __restrict__ reset, const float* __restrict__ gates,
    const float* __restrict__ hs, const float* __restrict__ dx3, float* st,
    unsigned c, unsigned N, int T, int H, int k0, int dcol, bool kok,
    bool jok, int tq[DW_COPIES]) {
  const int tid = threadIdx.x, q = (tid & 15) * 4;
  float* hsm = st;
  float* rsm = st + DW_TILE_F;
  float* dsm = st + 2 * DW_TILE_F;
#pragma unroll
  for (int i = 0; i < DW_COPIES; ++i) {
    const int row = (tid >> 4) + 8 * i;
    const unsigned n = c * DW_CH + row;
    const bool live = n < N;
    const bool hk = live && kok && tq[i] != 0;
    cp_async16(hsm + row * DW_LD + q,
               hs + (hk ? (size_t)(n - 1) * H + k0 + q : 0), hk);
    if (CAND)
      cp_async16(rsm + row * DW_LD + q,
                 gates + (hk ? (size_t)n * 3 * H + H + k0 + q : 0), hk);
    const bool dk = live && jok;
    cp_async16(dsm + row * DW_LD + q,
               dx3 + (dk ? (size_t)n * 3 * H + dcol + q : 0), dk);
    tq[i] += DW_CH;
    while (tq[i] >= T) tq[i] -= T;
  }
  if (RESET && tid < DW_CH) {
    const unsigned n = c * DW_CH + tid;
    cp_async4(st + 3 * DW_TILE_F + tid, reset + (n < N ? n : 0), n < N);
  }
}

// One block: the 64 x 64 tile (rows k0.., columns j0.. of the part, dWg
// when !CAND, dWc when CAND) over split blockIdx.z's chunks of pairs,
// written into its partial out + blockIdx.z * F (F = 3H^2 + 3H floats:
// dWg [H][2H], dWc [H][H], db [3H]). The blocks of the first k tile also
// sum db's columns of the tile.
template <bool CAND, bool RESET>
__device__ __forceinline__ void dw_block(
    const float* __restrict__ reset, const float* __restrict__ gates,
    const float* __restrict__ hs, const float* __restrict__ dx3,
    float* __restrict__ out, int B, int T, int H, int j0) {
  extern __shared__ __align__(16) float smem[];
  const int width = CAND ? H : 2 * H, col_off = CAND ? 2 * H : 0;
  const int tid = threadIdx.x, q = (tid & 15) * 4;
  const int k0 = blockIdx.y * DW_TILE;
  const unsigned N = (unsigned)B * (unsigned)T;
  const unsigned n_chunks = (N + DW_CH - 1) / DW_CH;
  const unsigned c_beg = (unsigned)((unsigned long long)n_chunks *
                                    blockIdx.z / gridDim.z);
  const unsigned c_end = (unsigned)((unsigned long long)n_chunks *
                                    (blockIdx.z + 1) / gridDim.z);
  const int nc = (int)(c_end - c_beg);
  const bool kok = k0 + q < H, jok = j0 + q < width;
  const bool has_db = blockIdx.y == 0;
  int tq[DW_COPIES];
#pragma unroll
  for (int i = 0; i < DW_COPIES; ++i)
    tq[i] = (int)((c_beg * DW_CH + (tid >> 4) + 8 * i) % (unsigned)T);
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  // db: column tid % 64 of the tile, rows 16 * (tid / 64) .. + 16 of each
  // chunk; the two halves added at the end
  float colsum = 0.f;
  const int db_col = tid & 63, db_row = (tid >> 6) * 16;

  if (nc > 0)
    dw_stage<CAND, RESET>(reset, gates, hs, dx3, smem, c_beg, N, T, H, k0,
                          col_off + j0, kok, jok, tq);
  cp_async_commit();
  for (int i = 0; i < nc; ++i) {
    const float* cur = smem + (i % DW_NS) * DW_STAGE;
    if (i + 1 < nc)
      dw_stage<CAND, RESET>(reset, gates, hs, dx3,
                            smem + ((i + 1) % DW_NS) * DW_STAGE,
                            c_beg + i + 1, N, T, H, k0, col_off + j0, kok,
                            jok, tq);
    cp_async_commit();
    cp_async_wait<1>();  // chunk i has landed (this thread's copies)
    __syncthreads();     // ... everyone's
    dw_chunk<CAND, RESET>(cur, acc);
    if (has_db) {
      const float* dsm = cur + 2 * DW_TILE_F;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        colsum += dsm[(db_row + r) * DW_LD + db_col];
    }
    __syncthreads();     // the stage takes chunk i + 2 next
  }
  cp_async_wait<0>();

  float* o = out + (size_t)blockIdx.z * ((size_t)3 * H * H + 3 * H);
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + (warp >> 1) * 32 + mt * 16 + g + (i >> 1) * 8;
        const int j = j0 + (warp & 1) * 32 + nt * 8 + 2 * t + (i & 1);
        if (k < H && j < width)
          o[CAND ? (size_t)2 * H * H + (size_t)k * H + j
                 : (size_t)k * 2 * H + j] = acc[mt][nt][i];
      }
  if (has_db) {
    float* red = smem;  // the ring is no longer read
    if (tid >= 64) red[db_col] = colsum;
    __syncthreads();
    if (tid < 64 && j0 + db_col < width)
      o[(size_t)3 * H * H + col_off + j0 + db_col] = colsum + red[db_col];
  }
}

// grid (dWg's column tiles then dWc's, k tiles, S splits of the pairs)
template <bool RESET>
__global__ void __launch_bounds__(DW_THREADS, 3)
gru_bwd_dw_kernel(const float* __restrict__ reset,
                  const float* __restrict__ gates,
                  const float* __restrict__ hs,
                  const float* __restrict__ dx3, float* __restrict__ out,
                  int B, int T, int H) {
  const int n_wg = (2 * H + DW_TILE - 1) / DW_TILE;
  if ((int)blockIdx.x < n_wg)
    dw_block<false, RESET>(reset, gates, hs, dx3, out, B, T, H,
                           blockIdx.x * DW_TILE);
  else
    dw_block<true, RESET>(reset, gates, hs, dx3, out, B, T, H,
                          (blockIdx.x - n_wg) * DW_TILE);
}

// on the calling thread's current device, which the wrapper sets
cudaError_t prepare(int B, int H) {
  return cudaFuncSetAttribute(gru_bwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(B, H));
}

// the cluster kernel of R rows a cluster on `stream`: grid (C, ceil(B /
// R)), clusters of C blocks
template <int R>
cudaError_t launch_cluster(const float* wg, const float* wc,
                           const float* mask, const float* reset,
                           const float* gates, const float* hs,
                           const float* g_hs, float* dx3, int B, int T, int H,
                           int C, cudaStream_t stream) {
  const size_t smem = cluster_smem_bytes(H, C, R);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_cluster_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(gru_bwd_cluster_kernel<R>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, (B + R - 1) / R);
  cfg.blockDim = dim3(CL_THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const bool vec = (((uintptr_t)gates | (uintptr_t)hs | (uintptr_t)g_hs) &
                    15) == 0;
  err = cudaLaunchKernelEx(&cfg, gru_bwd_cluster_kernel<R>, wg, wc, mask,
                           reset, gates, hs, g_hs, dx3, B, T, H, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of gru_bwd_kernel that can be resident at once on the current
// device for batch B and hidden size H (0 when a block's shared memory
// does not fit); a negative value is minus a cudaError_t. The launch needs
// H/U of them.
int gru_bwd_max_coresident_blocks(int B, int H) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -(int)err;
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return -(int)err;
  if (smem_bytes(B, H) > (size_t)smem_max) return 0;
  err = prepare(B, H);
  if (err != cudaSuccess) return -(int)err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gru_bwd_kernel, THREADS, smem_bytes(B, H));
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// Launches the reverse recurrence on `stream` of the current device;
// returns the cudaError_t of the launch (0 on success). `reset` may be
// NULL.
int gru_bwd(const float* wg, const float* wc, const float* mask,
            const float* reset, const float* gates, const float* hs,
            const float* g_hs, float* dx3, int B, int T, int H,
            void* stream) {
  cudaError_t err = prepare(B, H);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&wg,   (void*)&wc, (void*)&mask, (void*)&reset,
                  (void*)&gates, (void*)&hs, (void*)&g_hs, (void*)&dx3,
                  (void*)&B,    (void*)&T,  (void*)&H};
  err = cudaLaunchCooperativeKernel((const void*)gru_bwd_kernel,
                                    dim3(H / U), dim3(THREADS), args,
                                    smem_bytes(B, H), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The cluster path: C blocks a cluster (1 to 16, dividing H into U = H / C
// units a block, U a multiple of 4 dividing 256), R rows a cluster (1, 2,
// 4, 8 or 16). Launches on `stream` of the current device; returns the
// cudaError_t of the launch (0 on success). `reset` may be NULL; nothing
// else is needed.
int gru_bwd_cluster(const float* wg, const float* wc, const float* mask,
                    const float* reset, const float* gates, const float* hs,
                    const float* g_hs, float* dx3, int B, int T, int H, int C,
                    int R, void* stream) {
  if (B < 1 || T < 1 || C < 1 || C > CL_MAX_BLOCKS || H % C != 0 || R < 1 ||
      (B + R - 1) / R > 65535)
    return (int)cudaErrorInvalidValue;
  const int U = H / C;
  if (U % 4 != 0 || CL_THREADS % U != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 1:
      return (int)launch_cluster<1>(wg, wc, mask, reset, gates, hs, g_hs,
                                    dx3, B, T, H, C, st);
    case 2:
      return (int)launch_cluster<2>(wg, wc, mask, reset, gates, hs, g_hs,
                                    dx3, B, T, H, C, st);
    case 4:
      return (int)launch_cluster<4>(wg, wc, mask, reset, gates, hs, g_hs,
                                    dx3, B, T, H, C, st);
    case 8:
      return (int)launch_cluster<8>(wg, wc, mask, reset, gates, hs, g_hs,
                                    dx3, B, T, H, C, st);
    case 16:
      return (int)launch_cluster<16>(wg, wc, mask, reset, gates, hs, g_hs,
                                     dx3, B, T, H, C, st);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches the dW / db product on `stream` of the current device (an
// ordinary launch: its blocks need not be co-resident), its pairs split
// S ways: with S = 1 `out` receives [dWg | dWc | db] (3H^2 + 3H floats),
// else the S partials, which gru_bwd_dw_reduce sums. Returns the
// cudaError_t of the launch; cudaErrorInvalidValue for sizes or pointers
// it does not take (H % 4, 16-byte alignment, S above the chunks of
// pairs). `reset` may be NULL.
int gru_bwd_dw(const float* reset, const float* gates, const float* hs,
               const float* dx3, float* out, int B, int T, int H, int S,
               void* stream) {
  const long long N = (long long)B * T;
  const bool aligned = (((uintptr_t)gates | (uintptr_t)hs | (uintptr_t)dx3 |
                         (uintptr_t)out) & 15) == 0;
  if (B < 1 || T < 1 || H < 4 || H % 4 || N > 0x7FFFFFFFLL || S < 1 ||
      S > 65535 || S > (N + DW_CH - 1) / DW_CH || !aligned)
    return (int)cudaErrorInvalidValue;
  const void* kernel = reset != nullptr ? (const void*)gru_bwd_dw_kernel<true>
                                        : (const void*)gru_bwd_dw_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_wg = (2 * H + DW_TILE - 1) / DW_TILE;
  const int n_wc = (H + DW_TILE - 1) / DW_TILE;
  const int n_k = (H + DW_TILE - 1) / DW_TILE;
  const dim3 grid(n_wg + n_wc, n_k, S);
  if (reset != nullptr)
    gru_bwd_dw_kernel<true><<<grid, DW_THREADS, DW_SMEM,
                              (cudaStream_t)stream>>>(reset, gates, hs, dx3,
                                                      out, B, T, H);
  else
    gru_bwd_dw_kernel<false><<<grid, DW_THREADS, DW_SMEM,
                               (cudaStream_t)stream>>>(reset, gates, hs, dx3,
                                                       out, B, T, H);
  return (int)cudaGetLastError();
}

// Sums S partials [S][total] into out [total] in split order on `stream`
// of the current device; returns the cudaError_t of the launch.
int gru_bwd_dw_reduce(const float* part, float* out, int total, int S,
                      void* stream) {
  return (int)dw_reduce(part, out, total, S, (cudaStream_t)stream);
}

const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* gru_bwd_cluster_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* gru_bwd_dw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* gru_bwd_dw_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
