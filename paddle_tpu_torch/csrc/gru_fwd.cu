// Fused GRU forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/gru.py `_fwd_kernel` (launched by
// `_fwd_call`), the Pallas TPU kernel behind `fused_gru`'s forward. It
// computes the same thing: the masked GRU recurrence over a padded batch,
//   [z, r] = sigmoid(x[:, :2H] + h@Wg + b[:2H])
//   c      = tanh(x[:, 2H:] + (r*h)@Wc + b[2H:])
//   h'     = z*h + (1-z)*c
// with the mask-gated carry (h_t = m*h' + (1-m)*h_{t-1}) and the optional
// segment-start reset that zeroes the carry entering a step. It writes hs
// and, when training (a non-NULL `gates`), the TPU kernel's z|r|c stash
// [B, T, 3H] that the backward (gru_bwd.cu) reads: post-activation z, r
// and c at EVERY step, padded ones too, so the backward's products with
// the zero mask never meet uninitialised memory. Serving passes NULL and
// writes no stash.
//
// Layout: batch-major x3 [B, T, 3H], mask and reset [B, T], Wg [H, 2H],
// Wc [H, H], bias [3H], hs [B, T, H], gates [B, T, 3H]; all float32, all
// contiguous. The grid path also takes a scratch [2, B, H] (r*h_{t-1} and
// z).
//
// The grid kernel also has a bf16 form (gru_fwd_bf16), the TPU kernel's
// arithmetic on bf16 operands: x3, Wg, Wc, bias, hs and the stash bf16,
// mask and reset float32. The carry stays float32 (the TPU kernel's h_scr)
// in a third scratch plane beside z, and hs is its rounding (to nearest
// even), stored only as output; each product reads h_{t-1} from hs and
// r*h_{t-1} from a plane stored rounded, i.e. its operands rounded to bf16
// as jnp's astype before the dot, and sums the exact products in float32;
// the gates and activations are float32, and the stash is rounded on
// store. The weights are widened to float32 as a block loads them
// (exactly) and the row tile is bf16, so a block takes less shared memory
// than the float32 form's and every shape the float32 predicate accepts
// with H a multiple of 8 (16-byte runs of bf16) launches. The cluster
// kernel has the same bf16 form (gru_fwd_cluster_bf16, the same rule):
// its block keeps Wg's and Wc's columns widened to float32 (exactly, once,
// as it loads them: kept in bf16 and widened on each use they made a step
// 12% slower at the tagger's shape), the own units' carry in float32, and
// the rows' h_{t-1} and r*h_{t-1} of all units as their bf16 roundings
// stored as float, formed once a step by the unit's owner and exchanged
// so, so that no product widens an operand; x3 comes through a bf16
// ring. Its bound is not the float32 form's: bf16
// operands summed in float32 are the bf16 tensor cores' arithmetic, at
// 989 TFLOP/s the products below take about 0.010 ms, and the bf16 bytes
// (about 47.5 MB at that shape, with the stash) 0.014 ms, so bytes bound
// it; this kernel runs the products on the CUDA cores all the same.
//
// Bound on an H100 SXM: the two recurrent products cost 2*B*T*H*3H flops
// (10.07 GFLOP at B=64, T=100, H=512, every step valid), done in float32
// on the CUDA cores (67 TFLOP/s): about 0.150 ms. The bytes it must move
// (x3 read once, hs written once, Wg and Wc once: about 56 MB at that
// shape) take about 0.017 ms at 3.35 TB/s. So operations bound it, and the
// time loop is serial: each step needs all of h_{t-1} before any of h_t,
// and the candidate needs r*h_{t-1} of all H units before any of c. A step
// is latency: a chain of dependent exchanges, the products a few hundred
// cycles. PERF.md holds the kernels' measured times beside that bound
// (chip_smoke.py).
//
// Two kernels compute this; kernels/gru.py gru_fwd_plan picks one from
// (B, H) alone. Both split the weights across blocks by hidden unit: a
// block keeps the Wg (z and r) and Wc columns of its units in shared
// memory for the whole launch, and each step is two phases: (A) z and r of
// the block's units, and its slice of r*h_{t-1}; (B) the candidate and h_t
// of its units. Each phase ends with an exchange that every block waits
// for.
//
// The cluster path (gru_fwd_cluster_kernel), where the weights and the rows
// fit a thread-block cluster (the RNN CRF tagger's H = 128 among them):
// clusters of C <= 16 blocks (cudaLaunchKernelEx with a cluster dimension;
// above 8 the non-portable size), ceil(B / R) clusters, each owning R batch
// rows; block j of a cluster owns U = H / C units. Every block holds the
// cluster's R rows of h_{t-1} and of r*h_{t-1} in its own shared memory,
// k-major ([H][R], so the R rows of one k are one broadcast load, and a
// block's units' rows one run of UR floats). Phase A writes its r*h_{t-1}
// into its own copy, copies that run into the other C - 1 blocks' through
// distributed shared memory (map_shared_rank, 16 bytes a store), and meets
// them at a cluster barrier; phase B does the same with h_t. z and the
// block's own h_{t-1} never leave its shared memory. No global memory is
// on a step's path: x3's 3U columns of the block's units, the mask and the
// reset of step t+2 are copied by cp.async during step t into a ring of 3
// steps, and hs and the stash are stored and never read back. The products
// stay float32 FMA (as the plain version and the TPU kernel sum): 256
// threads, each a (column, k-part) pair, hold R independent sums over k =
// part, part + parts, ... (H/parts terms each: 16 in phase A at H = 128, U
// = 16), the R rows of a k one broadcast; the parts' sums are added in a
// fixed order, by the thread whose (column, part) names the output. A
// segment start zeroes h_{t-1}: the carry stays raw in shared memory, and
// the step scales its products and its uses of the carry by keep = 1 -
// reset (for a 0/1 reset the plain version's arithmetic). A step is
// latency: at the tagger's shape on an H100 an exchange and its barrier
// take some 0.72 us of the step's 2.9 (tools/torch_cluster_step_cost.py,
// tools/torch_gru_fwd_cluster.py). A barrier's release waits for every
// store before it, device memory's too (some 130 ns more), so each barrier
// is split: arrive after the exchange, then the phase's stores to hs and
// the stash (kept in registers) and the next copies into the ring, then
// wait. Shared memory: 4 * (3UH + 2HR + 256R + RU + 3U + 3(3UR + 2R))
// bytes, 46 KB at H = 128, C = 8, R = 8. No grid barrier, no cooperative
// launch, no global scratch.
//
// The grid path (gru_fwd_kernel), for the rest (the NMT encoder's H = 512:
// 3 MiB of weights do not fit a cluster of 16 beside its row tiles):
// block j owns hidden units [4j, 4j+4) and keeps their columns, 2*4 of Wg
// and 4 of Wc, 3*4*H floats (24 KB at H=512); every step is two phases
// over 32-row tiles of the batch, each phase closed by a grid barrier:
//   (A) stage h_{t-1}, form z and r for the block's units, and write its
//       slice of r*h_{t-1} and of z to the scratch;
//   grid.sync()
//   (B) stage the whole r*h_{t-1}, form c for the block's units, then
//       h_t from z, c and h_{t-1}, and write its slice of hs[:, t];
//   grid.sync()
// Both syncs sit in ONE persistent cooperative launch
// (cudaLaunchCooperativeKernel): every block must be resident at once, H/4
// blocks, checked against the occupancy API before each launch
// (gru_fwd_max_coresident_blocks); the Python wrapper raises when they are
// not. Data that other blocks wrote during the launch (hs, the scratch)
// is read through L2 (cp.async.cg, __ldcg), never a possibly stale L1
// line. A tile's h_{t-1} or r*h_{t-1} is staged as one batch of 16-byte
// cp.async copies; the phase's other inputs (x3's columns, the bias, mask
// and reset, and in phase B the block's own h_{t-1} and z) are loaded
// before the product, so that their latency overlaps it; each product is
// four independent FMA chains. A reset scales the products and the uses
// of the carry by keep = 1 - reset, as in the cluster path. z and the own
// h_{t-1} still pass through device memory: any B is taken here, and
// their shared-memory home would grow with it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int U = 4;                  // hidden units per block
constexpr int NA = 2 * U;             // phase A columns: z and r of U units
constexpr int NB = U;                 // phase B columns: c of U units
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / NA;    // batch rows per tile (32)
constexpr int KS = THREADS / (NB * ROWS);  // phase B splits k in KS parts

// shared memory: Wg columns [NA][H+4] and Wc columns [NB][H+4] as float
// (transposed, so a thread reads its column as float4 runs along k; the +4
// pad spreads the columns over the banks; bf16 weights are widened as they
// are loaded, exactly), the products [ROWS][NA] (phase A) or
// [KS][ROWS][NB] (phase B), both ROWS*NA floats, and one row tile
// [ROWS][H+VEC] of S (h_{t-1} in phase A, r*h_{t-1} in phase B; the pad of
// one 16-byte run keeps its rows aligned and spreads them over the banks)
template <typename S>
size_t smem_bytes(int H) {
  return sizeof(float) * ((size_t)(NA + NB) * (H + 4) + (size_t)ROWS * NA) +
         sizeof(S) * (size_t)ROWS * (H + VEC<S>);
}

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

// S = float: everything float32, the carry read back from hs. S = bf16
// (the TPU kernel on bf16 operands): x3, the weights, bias, hs, the stash
// and the r*h_{t-1} plane in bf16; the carry h_{t-1} float32 in its own
// plane (`carry`), hs its rounding, so that each product reads h_{t-1} and
// r*h_{t-1} rounded to bf16 (as jnp's astype before the dot) and sums the
// exact products in float32, while the gates, the carry and the
// activations stay float32. mask and reset are float32 in both.
template <typename S>
__global__ void __launch_bounds__(THREADS)
gru_fwd_kernel(const S* __restrict__ x3, const S* __restrict__ wg,
               const S* __restrict__ wc, const S* __restrict__ bias,
               const float* __restrict__ mask,
               const float* __restrict__ reset, S* hs,
               S* __restrict__ gates, S* rh, float* zbuf, float* carry,
               int B, int T, int H) {
  static_assert(NA * ROWS == THREADS && KS * NB * ROWS == THREADS,
                "thread layout");
  constexpr bool F32 = std::is_same<S, float>::value;
  constexpr int V = VEC<S>;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int LD = H + 4;
  const int LDT = H + V;
  float* wg_s = smem;                 // wg_s[c*LD + k] = Wg[k, gate col c]
  float* wc_s = wg_s + NA * LD;       // wc_s[c*LD + k] = Wc[k, u0 + c]
  float* prod = wc_s + NB * LD;       // products of the current phase
  S* tile = reinterpret_cast<S*>(prod + ROWS * NA);  // tile[r*LDT + k]

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;      // first hidden unit of this block
  const size_t H3 = 3 * (size_t)H;
  const int H_V = H / V;
  // column of x3 / Wg / bias that phase A's local column c stands for:
  // c / U is the gate (0 = z, 1 = r), c % U the unit
  auto gcol = [&](int c) { return (c / U) * H + u0 + c % U; };

  for (int i = tid; i < NA * H; i += THREADS) {
    const int k = i / NA, c = i % NA;
    wg_s[c * LD + k] = ld(wg + (size_t)k * 2 * H + gcol(c));
  }
  for (int i = tid; i < NB * H; i += THREADS) {
    const int k = i / NB, c = i % NB;
    wc_s[c * LD + k] = ld(wc + (size_t)k * H + u0 + c);
  }
  __syncthreads();

  // phase A: one thread per (column, row); phase B: per (column, row, k part)
  const int colA = tid % NA, rowA = tid / NA;
  const int colB = tid % NB, rowB = (tid / NB) % ROWS, part = tid / (NB * ROWS);
  const float bA = ld(bias + gcol(colA));
  const float4* wA = reinterpret_cast<const float4*>(wg_s + colA * LD);
  const float4* wB = reinterpret_cast<const float4*>(wc_s + colB * LD);

  for (int t = 0; t < T; ++t) {
    // ---- phase A: z and r of this block's units, r*h_{t-1} to scratch
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      const int nrows = min(ROWS, B - b0);
      // h_{t-1} of the tile's rows as stored in hs, one batch of 16-byte
      // copies through L2 (zeros at t = 0); a segment start's reset scales
      // its uses below
      for (int i = tid; i < nrows * H_V; i += THREADS) {
        const int r = i / H_V, kv = i % H_V;
        const size_t bt = (size_t)(b0 + r) * T + t;
        cp_async16(reinterpret_cast<float*>(tile + r * LDT + V * kv),
                   reinterpret_cast<const float*>(
                       t > 0 ? hs + (bt - 1) * H + V * kv : hs),
                   t > 0);
      }
      cp_async_commit();
      // the thread's other inputs, in flight during the copies and the
      // product
      float xa = 0.f, keep_a = 1.f, keep_o = 1.f, h_own = 0.f;
      if (rowA < nrows) {
        const size_t bt = (size_t)(b0 + rowA) * T + t;
        xa = ld(x3 + bt * H3 + gcol(colA));
        if (reset != nullptr) keep_a = 1.f - reset[bt];
      }
      if (tid < nrows * U) {
        if (reset != nullptr)
          keep_o = 1.f - reset[(size_t)(b0 + tid / U) * T + t];
        if (!F32 && t > 0)
          h_own = __ldcg(carry + (size_t)(b0 + tid / U) * H + u0 + tid % U);
      }
      cp_async_wait<0>();
      __syncthreads();

      if (rowA < nrows) {
        const S* hrow = tile + rowA * LDT;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};  // four independent chains
        for (int k4 = 0; k4 < H / 4; ++k4) {
          const float4 wv = wA[k4], hv = load4(hrow + 4 * k4);
          acc[0] = fmaf(hv.x, wv.x, acc[0]);
          acc[1] = fmaf(hv.y, wv.y, acc[1]);
          acc[2] = fmaf(hv.z, wv.z, acc[2]);
          acc[3] = fmaf(hv.w, wv.w, acc[3]);
        }
        const float sum = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        prod[rowA * NA + colA] = (xa + sum * keep_a) + bA;
      }
      __syncthreads();

      if (tid < nrows * U) {
        const int r = tid / U, uu = tid % U, j = u0 + uu;
        const size_t row = (size_t)(b0 + r) * H + j;
        const float z = sigm(prod[r * NA + uu]);
        const float rg = sigm(prod[r * NA + U + uu]);
        // the own unit's h_{t-1}: float32 in the tile (S = float) or the
        // carry plane (bf16), so r*h_{t-1} rounds once, as it is stored
        if constexpr (F32) h_own = tile[r * LDT + j];
        st(rh + row, rg * (h_own * keep_o));
        zbuf[row] = z;
        if (gates != nullptr) {
          const size_t bt = (size_t)(b0 + r) * T + t;
          st(gates + bt * H3 + j, z);
          st(gates + bt * H3 + H + j, rg);
        }
      }
      __syncthreads();  // tile and prod are refilled by the next tile
    }
    grid.sync();        // all of r*h_{t-1} written before any block reads it

    // ---- phase B: the candidate and h_t of this block's units
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      const int nrows = min(ROWS, B - b0);
      for (int i = tid; i < nrows * H_V; i += THREADS) {
        const int r = i / H_V, kv = i % H_V;
        cp_async16(reinterpret_cast<float*>(tile + r * LDT + V * kv),
                   reinterpret_cast<const float*>(rh + (size_t)(b0 + r) * H +
                                                  V * kv),
                   true);
      }
      cp_async_commit();
      // the output thread's inputs, in flight during the copies and the
      // product: x3's candidate column, the bias, the mask, the block's own
      // h_{t-1} (float32: from hs, or bf16's carry plane) and z
      float xc = 0.f, bc = 0.f, h_prev = 0.f, z = 0.f, m = 0.f;
      if (tid < nrows * U) {
        const int r = tid / U, j = u0 + tid % U;
        const size_t bt = (size_t)(b0 + r) * T + t;
        xc = ld(x3 + bt * H3 + 2 * H + j);
        bc = ld(bias + 2 * H + j);
        if (t > 0) {
          if constexpr (F32)
            h_prev = __ldcg(hs + (bt - 1) * H + j);
          else
            h_prev = __ldcg(carry + (size_t)(b0 + r) * H + j);
          if (reset != nullptr) h_prev *= 1.f - reset[bt];
        }
        z = __ldcg(zbuf + (size_t)(b0 + r) * H + j);
        m = mask[bt];
      }
      cp_async_wait<0>();
      __syncthreads();

      if (rowB < nrows) {
        const S* rrow = tile + rowB * LDT;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
        for (int k4 = part; k4 < H / 4; k4 += KS) {
          const float4 wv = wB[k4], hv = load4(rrow + 4 * k4);
          acc[0] = fmaf(hv.x, wv.x, acc[0]);
          acc[1] = fmaf(hv.y, wv.y, acc[1]);
          acc[2] = fmaf(hv.z, wv.z, acc[2]);
          acc[3] = fmaf(hv.w, wv.w, acc[3]);
        }
        prod[(part * ROWS + rowB) * NB + colB] =
            (acc[0] + acc[1]) + (acc[2] + acc[3]);
      }
      __syncthreads();

      if (tid < nrows * U) {
        const int r = tid / U, j = u0 + tid % U;
        const size_t bt = (size_t)(b0 + r) * T + t;
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < KS; ++p)
          acc += prod[(p * ROWS + r) * NB + tid % U];
        const float c = tanhf((xc + acc) + bc);
        if (gates != nullptr) st(gates + bt * H3 + 2 * H + j, c);
        const float h_new = z * h_prev + (1.f - z) * c;
        const float h = m * h_new + (1.f - m) * h_prev;
        st(hs + bt * H + j, h);
        if (!F32) carry[(size_t)(b0 + r) * H + j] = h;
      }
      __syncthreads();
    }
    grid.sync();        // hs[:, t] complete, and rh free, for step t+1
  }
}

// --- the cluster path -------------------------------------------------------

constexpr int CL_THREADS = 256;
constexpr int CL_MAX_BLOCKS = 16;  // blocks a cluster (above 8 non-portable)
constexpr int CL_NS = 3;           // stages of the x3 / mask / reset ring

// the floats of a 0/1 flag ring (mask or reset) of CL_NS steps of R rows,
// rounded up to 16 bytes
__host__ __device__ constexpr int flag_ring(int R) {
  return (CL_NS * R + 3) / 4 * 4;
}

// shared memory of a cluster block for hidden size H, C blocks a cluster
// and R rows a cluster (U = H / C units a block): Wg's 2U and Wc's U
// columns [H][3U] as float (bf16 widened as loaded, exactly), the R rows'
// carry and r*carry [H][R] each, the k-parts' partial sums
// [CL_THREADS][R], z [R][U], the biases [3U], and the ring of x3's 3U
// columns, mask and reset, CL_NS steps of R rows. S = bf16 adds the own
// units' float32 carry [U][R] (the rows' states are the roundings), and
// its x3 ring is bf16, after the floats (each mask and reset ring rounded
// up to 16 bytes). Every region a multiple of 16 bytes (the bf16 ring's
// rows where U % 8 == 0, the vector copies' case)
template <typename S>
size_t cluster_smem_bytes(int H, int C, int R) {
  const size_t U = H / C;
  if (std::is_same<S, float>::value)
    return sizeof(float) * (3 * U * H + 2 * (size_t)H * R
                            + (size_t)CL_THREADS * R + R * U + 3 * U
                            + CL_NS * (3 * U * R + 2 * (size_t)R));
  return sizeof(float) * (3 * U * H + 2 * (size_t)H * R
                          + (size_t)CL_THREADS * R + 2 * R * U + 3 * U
                          + 2 * (size_t)flag_ring(R))
         + sizeof(bf16) * CL_NS * 3 * U * R;
}

// a float rounded to the nearest bf16 (even on a tie), as a float
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one k-part's share of the R rows' products with column c of an [H][NC]
// weight block: k = part, part + KP, ...; written to psum[part][r][c]
template <int R>
__device__ __forceinline__ void rows_product(const float* wt, int NC,
                                             const float* rows, float* psum,
                                             int H, int c, int part,
                                             int KP) {
  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
  for (int k = part; k < H; k += KP)
    rows_fma<R>(acc, rows + k * R, wt[k * NC + c]);
#pragma unroll
  for (int r = 0; r < R; ++r) psum[(part * R + r) * NC + c] = acc[r];
}

// grid (C, ceil(B / R)), clusters of (C, 1, 1): cluster y owns batch rows
// [yR, yR + R), its block j hidden units [jU, jU + U). See the note at the
// top of the file. S = bf16: x3, the weights, bias, hs and the stash bf16;
// the weights widened to float32 as the block loads them (exactly: bf16
// weights read on each use cost 12% of a step at the tagger's shape,
// PERF.md), the block's own units' carry float32 ([U][R], `own`), the rows'
// h_{t-1} and r*h_{t-1} of all units held and exchanged as their bf16
// roundings (stored as float, so the products read them as they are),
// each product summing the exact products in float32
template <int R, typename S>
__global__ void __launch_bounds__(CL_THREADS, 1)
gru_fwd_cluster_kernel(const S* __restrict__ x3, const S* __restrict__ wg,
                       const S* __restrict__ wc, const S* __restrict__ bias,
                       const float* __restrict__ mask,
                       const float* __restrict__ reset,
                       S* __restrict__ hs, S* __restrict__ gates, int B,
                       int T, int H, bool vec) {
  constexpr bool F32 = std::is_same<S, float>::value;
  constexpr int V = VEC<S>;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float smem[];
  const int C = gridDim.x, U = H / C, NA = 2 * U;
  const int KA = CL_THREADS / NA, KB = CL_THREADS / U;
  const int u0 = blockIdx.x * U, b0 = blockIdx.y * R;
  const int tid = threadIdx.x;
  const size_t H3 = 3 * (size_t)H;
  float* wa = smem;               // [H][NA]: Wg[k, z | r column of unit c]
  float* wb = wa + H * NA;        // [H][U]: Wc[k, u0 + c]
  float* hprev = wb + H * U;      // [H][R]: h_{t-1} of the rows, all units
  float* rh = hprev + H * R;      // [H][R]: r * h_{t-1}, reset-gated
  float* psum = rh + H * R;       // [k-part][R][columns]
  float* zs = psum + CL_THREADS * R;         // [R][U]
  float* own = zs + R * U;        // bf16: [U][R], the own units' carry
  float* bs = own + (F32 ? 0 : U * R);       // [3U]: the biases of z, r, c
  S* xring;                       // [CL_NS][R][3U]: x3's z, r, c columns
  float* mring;                   // [CL_NS][R]
  float* rring;                   // [CL_NS][R]
  if constexpr (F32) {
    xring = bs + 3 * U;
    mring = xring + CL_NS * R * 3 * U;
    rring = mring + CL_NS * R;
  } else {
    mring = bs + 3 * U;
    rring = mring + flag_ring(R);
    xring = reinterpret_cast<S*>(rring + flag_ring(R));
  }

  for (int i = tid; i < H * NA; i += CL_THREADS) {
    const int k = i / NA, c = i % NA;
    wa[i] = ld(wg + (size_t)k * 2 * H + (c / U) * H + u0 + c % U);
  }
  for (int i = tid; i < H * U; i += CL_THREADS)
    wb[i] = ld(wc + (size_t)(i / U) * H + u0 + i % U);
  for (int i = tid; i < H * R; i += CL_THREADS) hprev[i] = 0.f;
  if constexpr (!F32)
    for (int i = tid; i < U * R; i += CL_THREADS) own[i] = 0.f;
  for (int i = tid; i < 3 * U; i += CL_THREADS)
    bs[i] = ld(bias + (i / U) * H + u0 + i % U);

  // step t's inputs into ring stage t % CL_NS: x3's 3U columns of the
  // block's units, mask and reset, for the cluster's rows (rows >= B read
  // as 0). With `vec` (U a multiple of V and x3 16-byte aligned) 16-byte
  // copies; else float's 4-byte ones, or bf16's plain loads and stores
  auto prefetch = [&](int t) {
    S* xs = xring + (t % CL_NS) * R * 3 * U;
    if (vec) {
      const int UV = U / V, n = R * 3 * UV;
      for (int i = tid; i < n; i += CL_THREADS) {
        const int r = i / (3 * UV), q = i % (3 * UV) * V;
        const bool ok = b0 + r < B;
        const size_t bt = (size_t)(b0 + r) * T + t;
        cp_async16(reinterpret_cast<float*>(xs + r * 3 * U + q),
                   reinterpret_cast<const float*>(
                       ok ? x3 + bt * H3 + (q / U) * H + u0 + q % U : x3),
                   ok);
      }
    } else {
      for (int i = tid; i < R * 3 * U; i += CL_THREADS) {
        const int r = i / (3 * U), q = i % (3 * U);
        const bool ok = b0 + r < B;
        const size_t bt = (size_t)(b0 + r) * T + t;
        const S* src = ok ? x3 + bt * H3 + (q / U) * H + u0 + q % U : x3;
        if constexpr (F32)
          cp_async4(xs + i, src, ok);
        else
          xs[i] = ok ? *src : __float2bfloat16_rn(0.f);
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
    if (q < T) prefetch(q);
    cp_async_commit();
  }
  cp_async_wait<CL_NS - 2>();  // step 0's inputs (this thread's copies)
  // every block of the cluster has started and holds its weights and a
  // zero carry before any block writes into another's shared memory
  cluster.sync();

  const int cA = tid % NA, pA = tid / NA;  // phase A: column, k-part
  const int gA = cA / U, uA = cA % U;      // its gate (0 z, 1 r) and unit
  const int cB = tid % U, pB = tid / U;    // phase B
  for (int t = 0; t < T; ++t) {
    const S* xs = xring + (t % CL_NS) * R * 3 * U;
    const float* ms = mring + (t % CL_NS) * R;
    const float* rs = rring + (t % CL_NS) * R;

    // ---- phase A: z and r of the block's units; r * h_{t-1} to every
    // block of the cluster. A segment start (reset) zeroes h_{t-1}: its
    // products are scaled by keep = 1 - reset, its carry too
    rows_product<R>(wa, NA, hprev, psum, H, cA, pA, KA);
    __syncthreads();
    // thread (cA, pA) forms column cA of rows pA + j * KA; it keeps them
    // (va) and stores them to the stash after the barrier's arrive, whose
    // release would wait for stores before it
    float va[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = pA + j * KA;
      if (r >= R) break;
      const float keep = reset != nullptr ? 1.f - rs[r] : 1.f;
      float a = 0.f;
      for (int p = 0; p < KA; ++p) a += psum[(p * R + r) * NA + cA];
      va[j] = sigm((ld(xs + r * 3 * U + cA) + a * keep) + bs[cA]);
      if (gA == 0) {
        zs[r * U + uA] = va[j];
      } else {
        const int i = (u0 + uA) * R + r;
        // r * h_{t-1} from the float32 carry, rounded once for bf16
        if constexpr (F32)
          rh[i] = va[j] * (hprev[i] * keep);
        else
          rh[i] = round_bf16(va[j] * (own[uA * R + r] * keep));
      }
    }
    __syncthreads();
    share_slice<CL_THREADS>(cluster, rh, u0 * R, U * R);
    cluster_arrive();
    // during the barrier: the stash's z and r, and the copies of step
    // t+2's inputs into the ring stage that step t-1 read
    if (gates != nullptr) {
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int r = pA + j * KA;
        if (r >= R) break;
        if (b0 + r < B)
          st(gates + ((size_t)(b0 + r) * T + t) * H3 + gA * H + u0 + uA,
             va[j]);
      }
    }
    if (t + CL_NS - 1 < T) prefetch(t + CL_NS - 1);
    cp_async_commit();
    cluster_wait();  // all of r * h_{t-1} is in every block

    // ---- phase B: the candidate and h_t of the block's units; h_t to
    // every block of the cluster
    rows_product<R>(wb, U, rh, psum, H, cB, pB, KB);
    __syncthreads();
    // thread (cB, pB) forms unit cB of rows pB + j * KB; c and h_t are
    // stored after the barrier's arrive, as phase A's gates
    float vc[R], vh[R];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int r = pB + j * KB;
      if (r >= R) break;
      const int i = (u0 + cB) * R + r;
      float a = 0.f;
      for (int p = 0; p < KB; ++p) a += psum[(p * R + r) * U + cB];
      vc[j] = tanhf((ld(xs + r * 3 * U + 2 * U + cB) + a) + bs[2 * U + cB]);
      const float carry = F32 ? hprev[i] : own[cB * R + r];
      const float h_prev = reset != nullptr ? carry * (1.f - rs[r]) : carry;
      const float z = zs[r * U + cB];
      const float h_new = z * h_prev + (1.f - z) * vc[j];
      const float m = ms[r];
      vh[j] = m * h_new + (1.f - m) * h_prev;
      if constexpr (F32) {
        hprev[i] = vh[j];
      } else {
        own[cB * R + r] = vh[j];
        hprev[i] = round_bf16(vh[j]);
      }
    }
    __syncthreads();
    share_slice<CL_THREADS>(cluster, hprev, u0 * R, U * R);
    cp_async_wait<CL_NS - 2>();  // step t+1's inputs (this thread's copies)
    cluster_arrive();
#pragma unroll
    for (int j = 0; j < R; ++j) {  // during the barrier: hs and c
      const int r = pB + j * KB;
      if (r >= R) break;
      if (b0 + r >= B) continue;
      const size_t bt = (size_t)(b0 + r) * T + t;
      st(hs + bt * H + u0 + cB, vh[j]);
      if (gates != nullptr) st(gates + bt * H3 + 2 * H + u0 + cB, vc[j]);
    }
    cluster_wait();  // h_t is in every block; step t+1's inputs are in
  }
}

// on the calling thread's current device, which the wrapper sets
template <typename S>
cudaError_t prepare(int H) {
  return cudaFuncSetAttribute(gru_fwd_kernel<S>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes<S>(H));
}

template <typename S>
int max_coresident_blocks(int H) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -(int)err;
  err = prepare<S>(H);
  if (err != cudaSuccess) return -(int)err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gru_fwd_kernel<S>, THREADS, smem_bytes<S>(H));
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// the grid kernel's cooperative launch: H/U blocks; `scratch` holds the
// r*h_{t-1} plane (B*H values of S, in a plane of B*H floats), z and, for
// bf16, the float32 carry (B*H floats each)
template <typename S>
int launch_grid(const S* x3, const S* wg, const S* wc, const S* bias,
                const float* mask, const float* reset, S* hs, S* gates,
                float* scratch, int B, int T, int H, void* stream) {
  cudaError_t err = prepare<S>(H);
  if (err != cudaSuccess) return (int)err;
  S* rh = reinterpret_cast<S*>(scratch);
  float* zbuf = scratch + (size_t)B * H;
  float* carry = std::is_same<S, float>::value ? nullptr
                                               : scratch + 2 * (size_t)B * H;
  void* args[] = {(void*)&x3,    (void*)&wg,    (void*)&wc,   (void*)&bias,
                  (void*)&mask,  (void*)&reset, (void*)&hs,   (void*)&gates,
                  (void*)&rh,    (void*)&zbuf,  (void*)&carry, (void*)&B,
                  (void*)&T,     (void*)&H};
  err = cudaLaunchCooperativeKernel((const void*)gru_fwd_kernel<S>,
                                    dim3(H / U), dim3(THREADS), args,
                                    smem_bytes<S>(H), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// the cluster kernel of R rows a cluster on `stream`: grid (C, ceil(B /
// R)), clusters of C blocks
template <int R, typename S>
cudaError_t launch_cluster(const S* x3, const S* wg, const S* wc,
                           const S* bias, const float* mask,
                           const float* reset, S* hs, S* gates, int B, int T,
                           int H, int C, cudaStream_t stream) {
  const size_t smem = cluster_smem_bytes<S>(H, C, R);
  cudaError_t err = cudaFuncSetAttribute(
      gru_fwd_cluster_kernel<R, S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(gru_fwd_cluster_kernel<R, S>,
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
  const bool vec = ((uintptr_t)x3 & 15) == 0 && (H / C) % VEC<S> == 0;
  err = cudaLaunchKernelEx(&cfg, gru_fwd_cluster_kernel<R, S>, x3, wg, wc,
                           bias, mask, reset, hs, gates, B, T, H, vec);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// the cluster path's checks, then the instance of R rows a cluster
template <typename S>
int cluster_entry(const S* x3, const S* wg, const S* wc, const S* bias,
                  const float* mask, const float* reset, S* hs, S* gates,
                  int B, int T, int H, int C, int R, void* stream) {
  if (B < 1 || T < 1 || C < 1 || C > CL_MAX_BLOCKS || H % C != 0 ||
      (B + R - 1) / R > 65535)
    return (int)cudaErrorInvalidValue;
  const int U = H / C;
  if (U % 4 != 0 || CL_THREADS % (2 * U) != 0 ||
      (!std::is_same<S, float>::value && H % VEC<S> != 0))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (R) {
    case 1:
      return (int)launch_cluster<1, S>(x3, wg, wc, bias, mask, reset, hs,
                                       gates, B, T, H, C, st);
    case 2:
      return (int)launch_cluster<2, S>(x3, wg, wc, bias, mask, reset, hs,
                                       gates, B, T, H, C, st);
    case 4:
      return (int)launch_cluster<4, S>(x3, wg, wc, bias, mask, reset, hs,
                                       gates, B, T, H, C, st);
    case 8:
      return (int)launch_cluster<8, S>(x3, wg, wc, bias, mask, reset, hs,
                                       gates, B, T, H, C, st);
    case 16:
      return (int)launch_cluster<16, S>(x3, wg, wc, bias, mask, reset, hs,
                                        gates, B, T, H, C, st);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// Blocks of gru_fwd_kernel that can be resident at once on the current
// device for hidden size H (any batch B: the kernel tiles it); a negative
// value is minus a cudaError_t. The launch needs H/U of them.
int gru_fwd_max_coresident_blocks(int B, int H) {
  return max_coresident_blocks<float>(H);
}

// Launches the recurrence on `stream` of the current device; returns the
// cudaError_t of the launch (0 on success). `reset` and `gates` (the stash)
// may be NULL; `scratch` holds 2*B*H floats.
int gru_fwd(const float* x3, const float* wg, const float* wc,
            const float* bias, const float* mask, const float* reset,
            float* hs, float* gates, float* scratch, int B, int T, int H,
            void* stream) {
  return launch_grid<float>(x3, wg, wc, bias, mask, reset, hs, gates,
                            scratch, B, T, H, stream);
}

// The grid kernel's bf16 form: x3, wg, wc, bias, hs and the stash bf16,
// mask and reset float32, `scratch` 3*B*H floats (the float32 carry among
// them); H a multiple of 8 (16-byte runs of bf16). As gru_fwd otherwise.
int gru_fwd_bf16_max_coresident_blocks(int B, int H) {
  return max_coresident_blocks<bf16>(H);
}

int gru_fwd_bf16(const bf16* x3, const bf16* wg, const bf16* wc,
                 const bf16* bias, const float* mask, const float* reset,
                 bf16* hs, bf16* gates, float* scratch, int B, int T, int H,
                 void* stream) {
  if (H % VEC<bf16> != 0) return (int)cudaErrorInvalidValue;
  return launch_grid<bf16>(x3, wg, wc, bias, mask, reset, hs, gates, scratch,
                           B, T, H, stream);
}

const char* gru_fwd_bf16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The cluster path: C blocks a cluster (1 to 16, dividing H into U = H / C
// units a block, U a multiple of 4 with 2U dividing 256), R rows a cluster
// (1, 2, 4, 8 or 16). Launches on `stream` of the current device; returns
// the cudaError_t of the launch (0 on success). `reset` and `gates` may be
// NULL; nothing else is needed.
int gru_fwd_cluster(const float* x3, const float* wg, const float* wc,
                    const float* bias, const float* mask, const float* reset,
                    float* hs, float* gates, int B, int T, int H, int C, int R,
                    void* stream) {
  return cluster_entry<float>(x3, wg, wc, bias, mask, reset, hs, gates, B, T,
                              H, C, R, stream);
}

// The cluster path's bf16 form: x3, wg, wc, bias, hs and the stash bf16,
// mask and reset float32; H a multiple of 8. As gru_fwd_cluster otherwise.
int gru_fwd_cluster_bf16(const bf16* x3, const bf16* wg, const bf16* wc,
                         const bf16* bias, const float* mask,
                         const float* reset, bf16* hs, bf16* gates, int B,
                         int T, int H, int C, int R, void* stream) {
  return cluster_entry<bf16>(x3, wg, wc, bias, mask, reset, hs, gates, B, T,
                             H, C, R, stream);
}

const char* gru_fwd_cluster_bf16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* gru_fwd_cluster_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* gru_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
