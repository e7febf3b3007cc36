// Fused LSTM backward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/lstm.py `_bwd_kernel` (launched by
// `_bwd_call`), the Pallas TPU kernel that walks the recurrence in reverse
// over the forward's gate stash and accumulates dW and the bias gradient
// in the kernel; and `_bwd_kernel_nodw` (launched by `_bwd_call_nodw`),
// its split form that writes dpre only, dW and db being one matmul and a
// few reductions outside. Here that work is the recurrence, then dW and a
// sum:
//   lstm_bwd            the reverse recurrence: dx4 = dpre (both forms);
//   lstm_bwd_dw         dW and db from dx4, hs and cs, launched once after
//                       it (a reduction over every (row, step) pair; dx4 is
//                       zero at padded steps, so they add nothing), the
//                       pairs split S ways;
//   lstm_bwd_dw_reduce  where S > 1, the S partials summed in split order.
// The split form runs lstm_bwd alone; its dW and db stay outside, as the
// JAX package forms them.
//
// What it computes, per step t from T-1 down to 0 (m = mask[b, t]):
//   dh_t = g_hs[t] + dh,  dc_t = g_cs[t] + dc       (dh, dc: carries)
//   dh_new = m*dh_t, dc_in = m*dc_t, the (1-m) parts pass through;
//   do = dh_new*tanh(c)*o(1-o)
//   dc_new = dh_new*o*(1-tanh(c)^2) + dc_in + do*po
//   di = dc_new*g*i(1-i), df = dc_new*c_prev*f(1-f), dg = dc_new*i(1-g^2)
//   dpre_t = [di, df, dg, do]                       (= dx4[:, t])
//   dc = dc_new*f + di*pi + df*pf + dc_pass
//   dh = dpre_t @ W^T + dh_pass
//   with a reset vector, both carries handed to t-1 are gated by
//   (1-reset[b, t]), and h_prev / c_prev are the effective (reset-gated)
//   states the forward consumed.
// lstm_bwd_dw forms dW = sum h_prev^T dpre and db = [sum dpre | sum
// di*c_prev | sum df*c_prev | sum do*c] over every (row, step) pair.
//
// Layout: batch-major, as the forward: gates [B, T, 4H] (post-activation
// i, f, g, o, written by lstm_fwd at every step, padded ones too, so the
// products below never meet uninitialised memory), hs and cs [B, T, H],
// g_hs and g_cs [B, T, H] (g_cs may be NULL: zero), mask and reset [B, T]
// (reset may be NULL), W [H, 4H], bias [7H]; out dx4 [B, T, 4H], dW
// [H, 4H] and db [7H]. All float32 (but see the bf16 forms below), all
// contiguous.
//
// Bound on an H100 SXM at B=64, T=100, H=512, every step valid: the dh
// product dpre @ W^T is 2*B*T*4H*H flops (13.4 GFLOP), 0.20 ms on the
// float32 CUDA cores at 67 TFLOP/s; the dW product as much again, which
// lstm_bwd_dw runs on the tensor cores in three TF32 passes, 40.3 GFLOP,
// 0.081 ms at 495 TFLOP/s. The bytes (gates, dx4, hs, cs, g_hs, g_cs:
// about 13H floats per (row, step), some 170 MB) take about 0.05 ms at
// 3.35 TB/s. So operations bound both, and the time loop of the recurrence
// is serial: each step needs all of step t+1's dpre.
//
// Design of lstm_bwd. The dh product contracts over 4H: dh[b, u] =
// dpre[b, :] . W[u, :]. A block owns U hidden units (16 where it fits, else
// 8 or 4) and R batch rows: grid (H / U, ceil(B / R)), one cooperative
// launch whose blocks are all resident (kernels/lstm.py lstm_bwd_plan picks
// U and R from the shape; the classifier's (64, 512) takes U = 16, R = 16:
// 32 unit groups x 4 row groups, 128 blocks). It keeps W's U rows in shared
// memory (U x 4H floats, 128 KiB at U = 16, H = 512) and the dc and dh
// pass-through carries of its (row, unit) pairs. Each step it stages only
// its own rows of dpre_{t+1} (written by the blocks of its row group into
// dx4[:, t+1] during the previous step), 4H floats each: the bytes staged
// a step across the grid are B*4H*4*(H/U), 16 MiB at the classifier's
// shape where a block of 4 units took 64. The rows come in tiles of RT =
// 256 / U (one (row, unit) pair a thread) and columns in chunks, RT x KC =
// 8192 floats, through a ring of NS = 2 cp.async.cg stages (L2 only: dx4
// was written by other blocks during the launch, so no possibly stale L1
// line may serve it): chunk i + 1's copies are in flight during chunk i's
// product. The product stays float32 FMA and takes most of a step, its
// shared-memory loads more than its FMAs: each of the 32 quarter-warps
// takes every 32nd float4 column of a chunk, its 8 lanes 32 outputs each
// (RT / 4 rows x U / 2 units, each a chain of its own), so 12 loads of 16
// bytes feed 128 FMAs at U = 16, and a lane loads column i + 1's operands
// into a second set of registers during column i's FMAs; a quarter-warp's
// loads of a column are 4 distinct dpre rows and 2 distinct W rows,
// each broadcast to the lanes that share it, and W's and a stage's rows
// are padded to an odd number of float4s, so they fall in distinct banks.
// The quarter-warps' sums are added by shuffles (each lane's 32 halved
// twice), the warps' sums of a (row, unit) in warp order by the thread
// that owns the pair, which holds its carries: no atomics, two launches
// give the same bits. The cell gradient's inputs (g_hs, g_cs, the 4 stash
// gates, cs[t], cs[t-1], mask, and the resets of steps t and t+1, the
// latter gating the dh carry) are loaded one tile ahead, a step ahead
// where a block holds one tile, so they are in registers when the product
// ends. grid.sync() closes each step: dx4[:, t] complete before any block
// reads it (a row group's H / U blocks exceed a cluster's 16 at H = 512).
//
// Design of lstm_bwd_dw: csrc/dw_tf32.cuh's pair reduction (3xTF32
// mma.sync, 64 x 64 output tiles, 32-pair chunks through two cp.async
// stages, fresh accumulators a chunk added in float32), as gru_bwd_dw: A =
// h_prev * (1 - reset), hs row n - 1 zero-filled at a row's first step,
// formed in float32 as the fragments are read; D = dx4's columns. The
// blocks of the first k tile also sum db's columns: dpre's, and the
// peepholes' dpre * c, staging beside the columns the cell states of their
// units (cs row n - 1, reset-gated, under the i and f gates; cs row n under
// o). The pairs are split S ways over the grid's third dimension, S chosen
// by the wrapper from the shape (4H/64 x H/64 tiles: 256 at H = 512, S =
// 2); with S = 1 a block writes the outputs, else its split's partial, and
// lstm_bwd_dw_reduce sums the partials in split order.
//
// The bf16 forms (the TPU kernels' arithmetic on bf16 operands, as on the
// JAX package's mixed-precision training path): lstm_bwd_bf16, the
// recurrence, and lstm_bwd_dw_bf16. W, bias, the stash, cs, g_hs, g_cs
// and dx4 are bf16, mask and reset float32. The recurrence reads the bf16
// stash (not the forward's float32 carries, as the TPU's _bwd_kernel),
// keeps the dh and dc carries and every step's arithmetic float32, and
// stores dx4 rounded to nearest even; dx4 is also its exchange between the
// blocks, so each dh product reads dpre rounded to bf16, as the TPU's dot,
// and sums the exact products in float32. W is widened to float32 as a
// block loads it and the ring's stages are bf16 (half the staged bytes).
// In the default form it also sums db [7H], the float32 sum of the
// UNROUNDED dpre and of the peepholes' di*c_prev, df*c_prev and do*c (c
// widened from bf16), which dx4 no longer holds: each thread sums its
// (row, unit) pairs' 7 items over the steps, in registers where its block
// holds one row tile (the classifier's plan) and else in a float32
// scratch [B][7H] (no block shares a pair); after the last step each
// row's sums are in the scratch and the blocks of the first row group
// sum their units' columns over the rows in order into db: no atomics,
// the same bits in every run. The split form (the
// TPU's _bwd_kernel_nodw) passes no db and sums nothing: its db comes from
// the rounded dx4 outside, as the JAX package forms it. lstm_bwd_dw_bf16
// forms dW only, on the same tiles, splits and order as lstm_bwd_dw, in ONE
// mma.sync m16n8k16 pass with bf16 operands and float32 accumulation (the
// pair reduction csrc/dw_bf16.cuh shares with gru_bwd_dw_bf16): A = h_prev
// * (1 - reset) (exact in bf16), D = dx4 as stored, the TPU's bf16 dot
// exactly; its partials [S][4H^2] go to lstm_bwd_dw_reduce. Bound on an
// H100 SXM at (64, 100, 512): the same operations as the float32 forms,
// but bf16 operands summed in float32 are the bf16 tensor cores'
// arithmetic, so at 989 TFLOP/s the recurrence's 13.4 GFLOP take about
// 0.014 ms and dW's as much; the bf16 bytes take about 0.020 ms for the
// recurrence (some 68 MB: the stash, cs, g_hs and dx4; 0.022 ms with
// g_cs), so bytes bound it, and 0.011 ms for dW (about 36 MB), so
// operations bound dW where every step is valid. The recurrence runs its
// products on the CUDA cores all the same. H must be a multiple of 8
// (16-byte runs of bf16).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "dw_bf16.cuh"
#include "dw_tf32.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

// --- lstm_bwd: the recurrence -------------------------------------------------

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int KPARTS = 4 * WARPS;  // the product's k-parts: quarter-warps
constexpr int NS = 2;              // stages of the dpre ring
constexpr int STAGE_F = 8192;      // floats a stage: RT rows x KC columns

// the layout of a block of U units with a ring of S: tiles of RT rows (a
// (row, unit) pair a thread), chunks of KC columns; the 8 lanes of a
// quarter-warp split a tile's outputs, a lane's RL rows r, r + 4, ... (r <
// 4) and UL units u, u + 2, ... (u < 2)
template <int U, typename S>
struct Layout {
  static constexpr int RT = THREADS / U;
  static constexpr int KC = STAGE_F / RT;
  static constexpr int V = VEC<S>;     // elements of S a 16-byte copy moves
  static constexpr int LDP = KC + V;   // an odd number of 16-byte runs
  static constexpr int RL = RT / 4;
  static constexpr int UL = U / 2;
  static_assert(RL * UL == 32, "32 outputs a lane");
};

// shared memory: W's rows [U][4H+4] as float, the warps' sums
// [WARPS][RT*U], the dc and dh pass-through carries [R][U] each (floats),
// and the ring [NS][RT][KC+V] of S
template <typename S>
size_t smem_bytes(int H, int U, int R) {
  const int RT = THREADS / U, KC = STAGE_F / RT;
  return sizeof(float) * ((size_t)U * (4 * H + 4) + (size_t)WARPS * THREADS +
                          2 * (size_t)R * U) +
         sizeof(S) * (size_t)NS * RT * (KC + VEC<S>);
}

// the cell gradient's inputs of one (row, unit) pair at a step, as loaded
// (rn: the reset of step t+1, which gates the dh carry into step t)
struct CellIn {
  float m, rs, rn, ghs, gcs, ig, fg, gg, og, c, cp;
};

template <typename S>
__device__ __forceinline__ CellIn cell_inputs(
    const float* __restrict__ mask, const float* __restrict__ reset,
    const S* __restrict__ gates, const S* __restrict__ cs,
    const S* __restrict__ g_hs, const S* __restrict__ g_cs, int b, int j,
    int t, int T, int H, bool live) {
  CellIn x = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (!live) return x;
  const size_t bt = (size_t)b * T + t;
  const S* g = gates + bt * 4 * (size_t)H;
  x.m = mask[bt];
  if (reset != nullptr) {
    x.rs = reset[bt];
    if (t + 1 < T) x.rn = reset[bt + 1];
  }
  x.ghs = ld(g_hs + bt * H + j);
  if (g_cs != nullptr) x.gcs = ld(g_cs + bt * H + j);
  x.ig = ld(g + j);
  x.fg = ld(g + H + j);
  x.gg = ld(g + 2 * H + j);
  x.og = ld(g + 3 * H + j);
  x.c = ld(cs + bt * H + j);
  if (t > 0) x.cp = ld(cs + (bt - 1) * H + j);
  return x;
}

// a lane's operands of float4 column k4: its RL rows rg + 4a of the staged
// tile (pitch LDP elements of S) as float4 and its UL units ug + 2e of W
// (pitch ldw4 float4s)
template <int RL, int UL, int LDP, typename S>
__device__ __forceinline__ void load_column(float4 (&p)[RL], float4 (&v)[UL],
                                            const S* st, const float4* wk,
                                            int ldw4, int rg, int ug,
                                            int k4) {
#pragma unroll
  for (int a = 0; a < RL; ++a) p[a] = load4(st + (rg + 4 * a) * LDP + 4 * k4);
#pragma unroll
  for (int e = 0; e < UL; ++e) v[e] = wk[(ug + 2 * e) * ldw4 + k4];
}

// acc[a][e] += p[a] . v[e], the 4 products of a column in order
template <int RL, int UL>
__device__ __forceinline__ void fma_column(float (&acc)[RL * UL],
                                           const float4 (&p)[RL],
                                           const float4 (&v)[UL]) {
#pragma unroll
  for (int a = 0; a < RL; ++a)
#pragma unroll
    for (int e = 0; e < UL; ++e) {
      float s = acc[a * UL + e];
      s = fmaf(p[a].x, v[e].x, s);
      s = fmaf(p[a].y, v[e].y, s);
      s = fmaf(p[a].z, v[e].z, s);
      s = fmaf(p[a].w, v[e].w, s);
      acc[a * UL + e] = s;
    }
}

// grid (H / U, ceil(B / R)): block (x, y) owns units [xU, xU + U) and rows
// [yR, yR + R), R a multiple of RT. See the note at the top of the file.
// S = float: everything float32, db NULL. S = bf16: W, bias, the stash,
// cs, g_hs, g_cs and dx4 bf16, the carries and the arithmetic float32;
// with db (the default form) it also sums db [7H] from the unrounded dpre,
// each row's sums in the scratch db + 7H [B][7H] (the note's bf16 forms).
// mask and reset are float32 in both.
template <int U, typename S>
__global__ void __launch_bounds__(THREADS, 1)
lstm_bwd_kernel(const S* __restrict__ w, const S* __restrict__ bias,
                const float* __restrict__ mask,
                const float* __restrict__ reset,
                const S* __restrict__ gates, const S* __restrict__ cs,
                const S* __restrict__ g_hs, const S* __restrict__ g_cs,
                S* dx4, float* db, int B, int T, int H, int R) {
  using L = Layout<U, S>;
  constexpr int RT = L::RT, KC = L::KC, LDP = L::LDP, RL = L::RL,
                UL = L::UL, V = L::V;
  constexpr bool F32 = std::is_same<S, float>::value;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H, LDW = H4 + 4;
  float* w_s = smem;                     // [U][LDW]: W[u0 + u, k]
  float* part = w_s + U * LDW;           // [WARPS][RT*U]: the warps' sums
  float* dc_s = part + WARPS * THREADS;  // [R][U]: the dc carry
  float* dhp_s = dc_s + R * U;           // [R][U]: the dh pass-through
  S* ring = reinterpret_cast<S*>(dhp_s + R * U);  // NS stages [RT][LDP]
  // bf16 with db: each row's sums over the steps, [B][7][H]
  float* dbs = F32 || db == nullptr ? nullptr : db + 7 * (size_t)H;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = blockIdx.x * U, b0 = blockIdx.y * R;
  const int tiles = R / RT;
  const int NC = (H4 + KC - 1) / KC;     // chunks a tile
  const int H4_4 = H4 / 4;

  for (int i = tid; i < U * H4_4; i += THREADS) {
    const int uu = i / H4_4, k4 = i % H4_4;
    reinterpret_cast<float4*>(w_s + uu * LDW)[k4] =
        load4(w + (size_t)(u0 + uu) * H4 + 4 * k4);
  }
  for (int i = tid; i < 2 * R * U; i += THREADS) dc_s[i] = 0.f;

  // the thread's (row, unit) pair of each tile, and its peepholes
  const int o_r = tid / U, o_u = tid % U, o_j = u0 + o_u;
  const float pi = ld(bias + 4 * H + o_j), pf = ld(bias + 5 * H + o_j),
              po = ld(bias + 6 * H + o_j);
  // the product: k-part kp (quarter-warp q of the warp) takes every
  // KPARTS-th float4 column of a chunk; the lane, rows rg + 4a and units
  // ug + 2e of a tile
  const int q4 = lane >> 3, kp = warp * 4 + q4;
  const int rg = (lane & 7) >> 1, ug = lane & 1;

  // chunk q of step t's sequence (tile q / NC, columns (q % NC) * KC ..)
  // of dpre_{t+1} into its ring stage, in 16-byte runs of V; rows past B
  // read as zeros
  auto stage = [&](int q, int t) {
    const int tb = b0 + (q / NC) * RT, k0 = (q % NC) * KC;
    const int nv = min(KC, H4 - k0) / V;
    S* st = ring + (q % NS) * RT * LDP;
    auto copy = [&](int r, int kv) {
      const bool ok = tb + r < B;
      cp_async16(reinterpret_cast<float*>(st + r * LDP + V * kv),
                 reinterpret_cast<const float*>(
                     ok ? dx4 + ((size_t)(tb + r) * T + t + 1) * H4 + k0 +
                              V * kv
                        : dx4),
                 ok);
    };
    if (nv == KC / V) {
#pragma unroll
      for (int i = 0; i < RT * KC / V / THREADS; ++i) {
        const int e = tid + i * THREADS;
        copy(e / (KC / V), e % (KC / V));
      }
    } else {  // the last chunk of a row whose 4H is not a multiple of KC
      for (int e = tid; e < RT * nv; e += THREADS) copy(e / nv, e % nv);
    }
  };

  CellIn nx = cell_inputs<S>(mask, reset, gates, cs, g_hs, g_cs, b0 + o_r,
                             o_j, T - 1, T, H, b0 + o_r < B);
  // bf16 with db, a block of one tile: the thread's one pair's sums over
  // the steps in registers (more tiles keep them in dbs)
  float dsum[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    const int total = t < T - 1 ? tiles * NC : 0;  // chunks this step
#pragma unroll
    for (int q = 0; q < NS - 1; ++q) {
      if (q < total) stage(q, t);
      cp_async_commit();
    }
    for (int i = 0; i < tiles; ++i) {
      const CellIn x = nx;
      {  // the next tile's inputs (step t-1's after the last), in flight
        const int ni = i + 1 < tiles ? i + 1 : 0;
        const int nt = i + 1 < tiles ? t : t - 1;
        const int nb = b0 + ni * RT + o_r;
        if (nt >= 0)
          nx = cell_inputs<S>(mask, reset, gates, cs, g_hs, g_cs, nb, o_j, nt,
                              T, H, nb < B);
      }
      const int r = i * RT + o_r;        // the pair's row in the block
      const int pr = r * U + o_u;        // its carries

      // dh into step t: dpre_{t+1} @ W[units]^T + the pass-through, gated
      // by the reset of step t+1
      float dh = 0.f;
      if (total > 0) {
        float acc[RL * UL];
#pragma unroll
        for (int a = 0; a < RL * UL; ++a) acc[a] = 0.f;
        for (int c = 0; c < NC; ++c) {
          const int q = i * NC + c;
          if (q + NS - 1 < total) stage(q + NS - 1, t);
          cp_async_commit();
          cp_async_wait<NS - 1>();  // chunk q has landed (this thread's)
          __syncthreads();          // ... everyone's
          const S* st = ring + (q % NS) * RT * LDP;
          const float4* wk = reinterpret_cast<const float4*>(w_s + c * KC);
          const int n4 = min(KC, H4 - c * KC) / 4;
          if (n4 == KC / 4) {
            // a whole chunk, IT columns a k-part: the loads of column
            // i + 1 are in flight during column i's FMAs (two register
            // sets), so the shared memory's pipe and the FMA pipes overlap
            constexpr int IT = KC / 4 / KPARTS;
            float4 p[2][RL], v[2][UL];
            load_column<RL, UL, LDP>(p[0], v[0], st, wk, LDW / 4, rg, ug,
                                     kp);
#pragma unroll
            for (int i = 0; i < IT; ++i) {
              if (i + 1 < IT)
                load_column<RL, UL, LDP>(p[(i + 1) & 1], v[(i + 1) & 1], st,
                                         wk, LDW / 4, rg, ug,
                                         kp + (i + 1) * KPARTS);
              fma_column<RL, UL>(acc, p[i & 1], v[i & 1]);
            }
          } else {  // the last chunk of a row whose 4H is not a multiple
            for (int k4 = kp; k4 < n4; k4 += KPARTS) {
              float4 p[RL], v[UL];
              load_column<RL, UL, LDP>(p, v, st, wk, LDW / 4, rg, ug, k4);
              fma_column<RL, UL>(acc, p, v);
            }
          }
          __syncthreads();          // the stage takes chunk q + NS next
        }
        // the 4 quarter-warps' sums, each lane's 32 halved twice: lane
        // (q, rg, ug) keeps the warp's sums of its entries 8q .. 8q + 7
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const bool up = lane & 16;
          const float keep = up ? acc[i + 16] : acc[i];
          acc[i] = keep + __shfl_xor_sync(0xffffffffu,
                                          up ? acc[i] : acc[i + 16], 16);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const bool up = lane & 8;
          const float keep = up ? acc[i + 8] : acc[i];
          acc[i] = keep + __shfl_xor_sync(0xffffffffu,
                                          up ? acc[i] : acc[i + 8], 8);
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int n = 8 * q4 + i;  // entry (row rg + 4a, unit ug + 2e)
          part[warp * THREADS + (rg + 4 * (n / UL)) * U + ug + 2 * (n % UL)] =
              acc[i];
        }
        __syncthreads();
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < WARPS; ++q) s += part[q * THREADS + tid];
        dh = (s + dhp_s[pr]) * (1.f - x.rn);
      }

      // the cell's gradient for the thread's pair, from the stash
      const int b = b0 + r;
      if (b < B) {
        const float m = x.m, p = 1.f - x.rs;
        const float dh_t = x.ghs + dh;
        const float dc_t = x.gcs + dc_s[pr];
        const float dh_new = m * dh_t, dc_in = m * dc_t;
        const float c_prev = x.cp * p;
        const float tanh_c = tanhf(x.c);
        const float d_o = dh_new * tanh_c * x.og * (1.f - x.og);
        const float dc_new =
            dh_new * x.og * (1.f - tanh_c * tanh_c) + dc_in + d_o * po;
        const float d_i = dc_new * x.gg * x.ig * (1.f - x.ig);
        const float d_f = dc_new * c_prev * x.fg * (1.f - x.fg);
        const float d_g = dc_new * x.ig * (1.f - x.gg * x.gg);
        dc_s[pr] = (dc_new * x.fg + d_i * pi + d_f * pf + (1.f - m) * dc_t)
                   * p;
        dhp_s[pr] = (1.f - m) * dh_t;
        S* out = dx4 + ((size_t)b * T + t) * H4;
        st(out + o_j, d_i);
        st(out + H + o_j, d_f);
        st(out + 2 * H + o_j, d_g);
        st(out + 3 * H + o_j, d_o);
        if (!F32 && dbs != nullptr) {
          // the pair's db items, unrounded: the gates' dpre, then the
          // peepholes' di*c_prev, df*c_prev, do*c
          const float items[7] = {d_i,          d_f,          d_g, d_o,
                                  d_i * c_prev, d_f * c_prev, d_o * x.c};
          float* q = dbs + (size_t)b * 7 * H + o_j;
#pragma unroll
          for (int k = 0; k < 7; ++k) {
            if (tiles == 1)
              dsum[k] += items[k];
            else  // the first step written
              q[k * H] = t == T - 1 ? items[k] : q[k * H] + items[k];
          }
        }
      }
    }
    if (t > 0) grid.sync();  // dx4[:, t] complete before any block reads it
  }
  cp_async_wait<0>();
  if (!F32 && dbs != nullptr) {
    // db: each row's sums in dbs, then the first row group's blocks sum
    // their units' 7 columns over every row, in row order
    if (tiles == 1 && b0 + o_r < B) {
#pragma unroll
      for (int k = 0; k < 7; ++k)
        dbs[((size_t)(b0 + o_r) * 7 + k) * H + o_j] = dsum[k];
    }
    grid.sync();
    if (blockIdx.y == 0 && tid < 7 * U) {
      const int k = tid / U, j = u0 + tid % U;
      float sum = 0.f;
      for (int b = 0; b < B; ++b)
        sum += __ldcg(dbs + ((size_t)b * 7 + k) * H + j);
      db[k * H + j] = sum;
    }
  }
}

template <int U, typename S>
cudaError_t launch(const S* w, const S* bias, const float* mask,
                   const float* reset, const S* gates, const S* cs,
                   const S* g_hs, const S* g_cs, S* dx4, float* db, int B,
                   int T, int H, int R, cudaStream_t stream) {
  const size_t smem = smem_bytes<S>(H, U, R);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_bwd_kernel<U, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&w,    (void*)&bias, (void*)&mask, (void*)&reset,
                  (void*)&gates, (void*)&cs,  (void*)&g_hs, (void*)&g_cs,
                  (void*)&dx4,  (void*)&db,   (void*)&B,    (void*)&T,
                  (void*)&H,    (void*)&R};
  err = cudaLaunchCooperativeKernel((const void*)lstm_bwd_kernel<U, S>,
                                    dim3(H / U, (B + R - 1) / R),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// lstm_bwd_kernel<U, S>'s launch for U of 4, 8 or 16
template <typename S>
int launch_units(const S* w, const S* bias, const float* mask,
                 const float* reset, const S* gates, const S* cs,
                 const S* g_hs, const S* g_cs, S* dx4, float* db, int B,
                 int T, int H, int U, int R, cudaStream_t st) {
  if (B < 1 || T < 1 || H < 4 || R < 1 || (U != 4 && U != 8 && U != 16) ||
      H % U != 0 || R % (THREADS / U) != 0 || (B + R - 1) / R > 65535)
    return (int)cudaErrorInvalidValue;
  switch (U) {
    case 4:
      return (int)launch<4, S>(w, bias, mask, reset, gates, cs, g_hs, g_cs,
                               dx4, db, B, T, H, R, st);
    case 8:
      return (int)launch<8, S>(w, bias, mask, reset, gates, cs, g_hs, g_cs,
                               dx4, db, B, T, H, R, st);
    default:
      return (int)launch<16, S>(w, bias, mask, reset, gates, cs, g_hs, g_cs,
                                dx4, db, B, T, H, R, st);
  }
}

// --- lstm_bwd_dw: 3xTF32 mma.sync, the pair reduction split over the grid --

// Start the copies of chunk c (pairs n = c*DW_CH + row) into stage `st`:
// the rows of h_prev, hs row n - 1, zero-filled at a row's first step (n %
// T == 0) and past N; dx4's columns of the tile (from j0, `jok` when the
// thread's 4 lie inside 4H); with `db` the cell states under the columns,
// cs row n - 1 (zero-filled at a row's first step) under the i and f
// gates, cs row n under o, zeros under g; reset[n]. Thread tid copies
// columns 4 * (tid % 16) of rows tid / 16 + 8i, whose n % T it keeps in
// tq[i], advanced here to the next chunk.
template <bool RESET>
__device__ __forceinline__ void dw_stage(
    const float* __restrict__ reset, const float* __restrict__ hs,
    const float* __restrict__ cs, const float* __restrict__ dx4, float* st,
    unsigned c, unsigned N, int T, int H, int k0, int j0, bool kok,
    bool jok, bool db, int gate, int unit, int tq[DW_COPIES]) {
  const int tid = threadIdx.x, q = (tid & 15) * 4;
  float* hsm = st;
  float* csm = st + DW_TILE_F;
  float* dsm = st + 2 * DW_TILE_F;
#pragma unroll
  for (int i = 0; i < DW_COPIES; ++i) {
    const int row = (tid >> 4) + 8 * i;
    const unsigned n = c * DW_CH + row;
    const bool live = n < N, first = tq[i] == 0;
    const bool hk = live && kok && !first;
    cp_async16(hsm + row * DW_LD + q,
               hs + (hk ? (size_t)(n - 1) * H + k0 + q : 0), hk);
    const bool dk = live && jok;
    cp_async16(dsm + row * DW_LD + q,
               dx4 + (dk ? (size_t)n * 4 * H + j0 + q : 0), dk);
    if (db) {
      const bool ck = dk && gate != 2 && (gate == 3 || !first);
      const size_t m = gate == 3 ? n : n - 1;
      cp_async16(csm + row * DW_LD + q, cs + (ck ? m * H + unit : 0), ck);
    }
    tq[i] += DW_CH;
    while (tq[i] >= T) tq[i] -= T;
  }
  if (RESET && tid < DW_CH) {
    const unsigned n = c * DW_CH + tid;
    cp_async4(st + 3 * DW_TILE_F + tid, reset + (n < N ? n : 0), n < N);
  }
}

// grid (4H / 64 column tiles, H / 64 k tiles, S splits of the pairs): the
// 64 x 64 tile (rows k0.., columns j0..) over split blockIdx.z's chunks of
// pairs, written into its partial out + blockIdx.z * F (F = 4H^2 + 7H
// floats: dW [H][4H], db [7H]). The blocks of the first k tile also sum
// db's columns of the tile.
template <bool RESET>
__global__ void __launch_bounds__(DW_THREADS, 3)
lstm_bwd_dw_kernel(const float* __restrict__ reset,
                   const float* __restrict__ hs,
                   const float* __restrict__ cs,
                   const float* __restrict__ dx4, float* __restrict__ out,
                   int B, int T, int H) {
  extern __shared__ __align__(16) float smem[];
  const int H4 = 4 * H;
  const int tid = threadIdx.x, q = (tid & 15) * 4;
  const int j0 = blockIdx.x * DW_TILE, k0 = blockIdx.y * DW_TILE;
  const unsigned N = (unsigned)B * (unsigned)T;
  const unsigned n_chunks = (N + DW_CH - 1) / DW_CH;
  const unsigned c_beg = (unsigned)((unsigned long long)n_chunks *
                                    blockIdx.z / gridDim.z);
  const unsigned c_end = (unsigned)((unsigned long long)n_chunks *
                                    (blockIdx.z + 1) / gridDim.z);
  const int nc = (int)(c_end - c_beg);
  const bool kok = k0 + q < H, jok = j0 + q < H4;
  const bool has_db = blockIdx.y == 0;
  // the gate and unit of the thread's 4 staged columns (H % 4 == 0: one
  // gate) for the cell states
  const int s_gate = (j0 + q) / H, s_unit = j0 + q - s_gate * H;
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
  // chunk, dpre's sum and the peephole's dpre * c; the halves added at
  // the end
  float colsum = 0.f, pesum = 0.f;
  const int db_col = tid & 63, db_row = (tid >> 6) * 16;
  const int jc = j0 + db_col, gc = jc / H;
  const bool gated = RESET && gc < 2;  // c_prev takes the reset

  if (nc > 0)
    dw_stage<RESET>(reset, hs, cs, dx4, smem, c_beg, N, T, H, k0, j0, kok,
                    jok, has_db, s_gate, s_unit, tq);
  cp_async_commit();
  for (int i = 0; i < nc; ++i) {
    const float* cur = smem + (i % DW_NS) * DW_STAGE;
    if (i + 1 < nc)
      dw_stage<RESET>(reset, hs, cs, dx4, smem + ((i + 1) % DW_NS) * DW_STAGE,
                      c_beg + i + 1, N, T, H, k0, j0, kok, jok, has_db,
                      s_gate, s_unit, tq);
    cp_async_commit();
    cp_async_wait<1>();  // chunk i has landed (this thread's copies)
    __syncthreads();     // ... everyone's
    dw_chunk<false, RESET>(cur, acc);
    if (has_db) {
      const float* csm = cur + DW_TILE_F;
      const float* dsm = cur + 2 * DW_TILE_F;
      const float* psm = cur + 3 * DW_TILE_F;
#pragma unroll
      for (int r = 0; r < 16; ++r) {
        const int at = (db_row + r) * DW_LD + db_col;
        const float d = dsm[at];
        float c = csm[at];
        if (gated) c *= 1.f - psm[db_row + r];
        colsum += d;
        pesum = fmaf(d, c, pesum);
      }
    }
    __syncthreads();     // the stage takes chunk i + 2 next
  }
  cp_async_wait<0>();

  float* o = out + (size_t)blockIdx.z * ((size_t)H4 * H + 7 * H);
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + (warp >> 1) * 32 + mt * 16 + g + (i >> 1) * 8;
        const int j = j0 + (warp & 1) * 32 + nt * 8 + 2 * t + (i & 1);
        if (k < H && j < H4) o[(size_t)k * H4 + j] = acc[mt][nt][i];
      }
  if (has_db) {
    float* red = smem;  // the ring is no longer read
    if (tid >= 64) {
      red[db_col] = colsum;
      red[64 + db_col] = pesum;
    }
    __syncthreads();
    if (tid < 64 && jc < H4) {
      float* db = o + (size_t)H4 * H;
      db[jc] = colsum + red[db_col];
      // [gate biases i, f, g, o | pi | pf | po], each H long
      if (gc != 2)
        db[(gc == 3 ? 6 : 4 + gc) * H + jc - gc * H] =
            pesum + red[64 + db_col];
    }
  }
}

// --- lstm_bwd_dw_bf16: one bf16 mma.sync pass ----------------------------
// The same tiles, splits and fixed order as lstm_bwd_dw, its operands bf16
// (csrc/dw_bf16.cuh): A = h_prev * (1 - reset), hs row n - 1 zero-filled at
// a row's first step; D = dx4's bf16 columns as stored. No db: the bf16
// recurrence sums it from the unrounded dpre.

// grid (4H / 64 column tiles, H / 64 k tiles, S splits of the pairs): the
// 64 x 64 tile (rows k0.., columns j0..) over split blockIdx.z's chunks of
// pairs, written into its partial out + blockIdx.z * 4H^2 (dW [H][4H])
template <bool RESET>
__global__ void __launch_bounds__(DW_THREADS, 3)
lstm_bwd_dw_bf16_kernel(const float* __restrict__ reset,
                        const bf16* __restrict__ hs,
                        const bf16* __restrict__ dx4, float* __restrict__ out,
                        int B, int T, int H) {
  extern __shared__ __align__(16) char smem_b[];
  const int H4 = 4 * H;
  const int tid = threadIdx.x, q = (tid & 7) * 8;
  const int j0 = blockIdx.x * DW_TILE, k0 = blockIdx.y * DW_TILE;
  const unsigned N = (unsigned)B * (unsigned)T;
  const unsigned n_chunks = (N + DW_CH - 1) / DW_CH;
  const unsigned c_beg = (unsigned)((unsigned long long)n_chunks *
                                    blockIdx.z / gridDim.z);
  const unsigned c_end = (unsigned)((unsigned long long)n_chunks *
                                    (blockIdx.z + 1) / gridDim.z);
  const int nc = (int)(c_end - c_beg);
  const bool kok = k0 + q < H, jok = j0 + q < H4;
  int tq[DWB_COPIES];
#pragma unroll
  for (int i = 0; i < DWB_COPIES; ++i)
    tq[i] = (int)((c_beg * DW_CH + (tid >> 3) + 16 * i) % (unsigned)T);
  float acc[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  if (nc > 0)
    dwb_stage<false, RESET>(reset, nullptr, hs, dx4, smem_b, c_beg, N, T, H,
                            k0, j0, H4, kok, jok, tq);
  cp_async_commit();
  for (int i = 0; i < nc; ++i) {
    const char* cur = smem_b + (i % DW_NS) * DWB_STAGE_BYTES;
    if (i + 1 < nc)
      dwb_stage<false, RESET>(reset, nullptr, hs, dx4,
                              smem_b + ((i + 1) % DW_NS) * DWB_STAGE_BYTES,
                              c_beg + i + 1, N, T, H, k0, j0, H4, kok, jok,
                              tq);
    cp_async_commit();
    cp_async_wait<1>();  // chunk i has landed (this thread's copies)
    __syncthreads();     // ... everyone's
    dwb_chunk<false, RESET>(cur, acc);
    __syncthreads();     // the stage takes chunk i + 2 next
  }
  cp_async_wait<0>();

  float* o = out + (size_t)blockIdx.z * ((size_t)H4 * H);
  const int lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + (warp >> 1) * 32 + mt * 16 + g + (i >> 1) * 8;
        const int j = j0 + (warp & 1) * 32 + nt * 8 + 2 * t + (i & 1);
        if (k < H && j < H4) o[(size_t)k * H4 + j] = acc[mt][nt][i];
      }
}

}  // namespace

extern "C" {

// The recurrence: U hidden units a block (4, 8 or 16, dividing H), R batch
// rows a block (a multiple of 256 / U); grid (H / U, ceil(B / R)), every
// block resident at once (a cooperative launch, refused where they are
// not). Launches on `stream` of the current device; returns the
// cudaError_t of the launch (0 on success). `reset` and `g_cs` may be NULL.
int lstm_bwd(const float* w, const float* bias, const float* mask,
             const float* reset, const float* gates, const float* cs,
             const float* g_hs, const float* g_cs, float* dx4, int B, int T,
             int H, int U, int R, void* stream) {
  return launch_units<float>(w, bias, mask, reset, gates, cs, g_hs, g_cs,
                             dx4, nullptr, B, T, H, U, R,
                             (cudaStream_t)stream);
}

// The recurrence's bf16 form: w, bias, gates, cs, g_hs, g_cs and dx4
// bf16, mask and reset float32; H a multiple of 8. With `db` (the default
// form) it also writes db [7H] floats, the sum of the unrounded dpre and
// the peepholes' gradients, using db + 7H, B * 7H floats more, as its
// scratch; NULL (the split form) sums nothing. As lstm_bwd otherwise.
int lstm_bwd_bf16(const bf16* w, const bf16* bias, const float* mask,
                  const float* reset, const bf16* gates, const bf16* cs,
                  const bf16* g_hs, const bf16* g_cs, bf16* dx4, float* db,
                  int B, int T, int H, int U, int R, void* stream) {
  if (H % VEC<bf16> != 0) return (int)cudaErrorInvalidValue;
  return launch_units<bf16>(w, bias, mask, reset, gates, cs, g_hs, g_cs, dx4,
                            db, B, T, H, U, R, (cudaStream_t)stream);
}

const char* lstm_bwd_bf16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Launches the dW / db product on `stream` of the current device (an
// ordinary launch: its blocks need not be co-resident), its pairs split
// S ways: with S = 1 `out` receives [dW | db] (4H^2 + 7H floats), else the
// S partials, which lstm_bwd_dw_reduce sums. Returns the cudaError_t of the
// launch; cudaErrorInvalidValue for sizes or pointers it does not take
// (H % 4, 16-byte alignment, S above the chunks of pairs). `reset` may be
// NULL.
int lstm_bwd_dw(const float* reset, const float* hs, const float* cs,
                const float* dx4, float* out, int B, int T, int H, int S,
                void* stream) {
  const long long N = (long long)B * T;
  const bool aligned = (((uintptr_t)hs | (uintptr_t)cs | (uintptr_t)dx4 |
                         (uintptr_t)out) & 15) == 0;
  if (B < 1 || T < 1 || H < 4 || H % 4 || N > 0x7FFFFFFFLL || S < 1 ||
      S > 65535 || S > (N + DW_CH - 1) / DW_CH || !aligned)
    return (int)cudaErrorInvalidValue;
  const void* kernel = reset != nullptr
                           ? (const void*)lstm_bwd_dw_kernel<true>
                           : (const void*)lstm_bwd_dw_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((4 * H + DW_TILE - 1) / DW_TILE,
                  (H + DW_TILE - 1) / DW_TILE, S);
  if (reset != nullptr)
    lstm_bwd_dw_kernel<true><<<grid, DW_THREADS, DW_SMEM,
                               (cudaStream_t)stream>>>(reset, hs, cs, dx4,
                                                       out, B, T, H);
  else
    lstm_bwd_dw_kernel<false><<<grid, DW_THREADS, DW_SMEM,
                                (cudaStream_t)stream>>>(reset, hs, cs, dx4,
                                                        out, B, T, H);
  return (int)cudaGetLastError();
}

// The dW product's bf16 form: hs and dx4 bf16, `reset` float32 or NULL;
// `out` receives dW (4H^2 floats) with S = 1, else the S partials, which
// lstm_bwd_dw_reduce sums. H a multiple of 8; the rest as lstm_bwd_dw.
int lstm_bwd_dw_bf16(const float* reset, const bf16* hs, const bf16* dx4,
                     float* out, int B, int T, int H, int S, void* stream) {
  const long long N = (long long)B * T;
  const bool aligned =
      (((uintptr_t)hs | (uintptr_t)dx4 | (uintptr_t)out) & 15) == 0;
  if (B < 1 || T < 1 || H < 8 || H % 8 || N > 0x7FFFFFFFLL || S < 1 ||
      S > 65535 || S > (N + DW_CH - 1) / DW_CH || !aligned)
    return (int)cudaErrorInvalidValue;
  const void* kernel =
      reset != nullptr ? (const void*)lstm_bwd_dw_bf16_kernel<true>
                       : (const void*)lstm_bwd_dw_bf16_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, DWB_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((4 * H + DW_TILE - 1) / DW_TILE,
                  (H + DW_TILE - 1) / DW_TILE, S);
  if (reset != nullptr)
    lstm_bwd_dw_bf16_kernel<true><<<grid, DW_THREADS, DWB_SMEM,
                                    (cudaStream_t)stream>>>(reset, hs, dx4,
                                                            out, B, T, H);
  else
    lstm_bwd_dw_bf16_kernel<false><<<grid, DW_THREADS, DWB_SMEM,
                                     (cudaStream_t)stream>>>(reset, hs, dx4,
                                                             out, B, T, H);
  return (int)cudaGetLastError();
}

const char* lstm_bwd_dw_bf16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// Sums S partials [S][total] into out [total] in split order on `stream`
// of the current device; returns the cudaError_t of the launch.
int lstm_bwd_dw_reduce(const float* part, float* out, int total, int S,
                       void* stream) {
  return (int)dw_reduce(part, out, total, S, (cudaStream_t)stream);
}

const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* lstm_bwd_dw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* lstm_bwd_dw_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
