// Fused GRU backward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/gru.py `_bwd_kernel` (launched by
// `_bwd_call`), the Pallas TPU kernel that walks the GRU recurrence in
// reverse over the forward's z|r|c stash and accumulates dWg, dWc and the
// bias gradient in the kernel. Here that work is two kernels and a sum:
//   gru_bwd            the reverse recurrence: dx3 = [dz_pre | dr_pre |
//                      dc_pre];
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
// operations bound both, and the time loop of gru_bwd is serial: each
// step needs all of step t+1's dh.
//
// Design of gru_bwd. As in the forward, block j owns hidden units
// [4j, 4j+4) and keeps the weights' ROWS for them in shared memory, Wc's 4
// rows (4 x H) and Wg's (4 x 2H), 24 KB at H=512, because both dh products
// contract over the gate columns: drh[b, u] = dc_pre[b, :] . Wc[u, :] and
// the same with dg and Wg. A step holds two products that depend on each
// other: drh needs all of dc_pre, and dg's dr_pre half needs drh. So each
// step is three phases, two grid barriers:
//   (1) local: dc_pre and dz_pre of the block's units from the stash and
//       the dh carry; write them to dx3;
//   grid.sync()
//   (2) per tile of 16 batch rows: stage dc_pre[:, t] (all H) and form drh
//       for the block's units; dr_pre to dx3, drh*r into the carry;
//   grid.sync()
//   (3) per tile: stage [dz_pre | dr_pre][:, t] (all 2H), add dg @ Wg^T
//       into the carry, gate it by the reset.
// Phase 3 of step t and phase 1 of step t-1 need no barrier between them:
// the dh carry of a block's own units never leaves the block (shared
// memory, [B][4]). At t = 0 phases 2 and 3 are skipped: h_prev is zero
// there, so dr_pre is zero and the carry is not needed. dx3 written by
// other blocks during the launch is staged with cp.async.cg (L2 only),
// never through a possibly stale L1 line. The launch is cooperative: H/4
// blocks that must all be resident (about 90 KB of shared memory each at
// H=512, 128 blocks on 132 SMs); the wrapper asks
// gru_bwd_max_coresident_blocks(B, H) and raises when they do not fit.
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

namespace cg = cooperative_groups;

namespace {

constexpr int U = 4;                    // hidden units per block
constexpr int THREADS = 256;
constexpr int ROWS = 16;                // batch rows per staged tile
constexpr int KSPLIT = THREADS / ROWS;  // lanes per row in the products
static_assert(KSPLIT == 16, "the shuffle reduction below sums 16 lanes");

// shared memory, in floats: Wc rows [U][H+4], Wg rows [U][2H+4], the
// staged tile [ROWS][2H+4] (dc_pre rows in phase 2, dg rows in phase 3),
// the dh carry [B][U]
size_t smem_floats(int B, int H) {
  return (size_t)U * (H + 4) + (size_t)U * (2 * H + 4) +
         (size_t)ROWS * (2 * H + 4) + (size_t)B * U;
}

size_t smem_bytes(int B, int H) { return sizeof(float) * smem_floats(B, H); }

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without a register round trip, cached in L2
// only (.cg): the recurrence's source was written by another block during
// its launch. With `ok` false it reads nothing and fills the destination
// with zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// columns [col0, col0+width) of rows [b0, b0+nrows) of dx3 [B, T, 3H] at
// step t into a tile of row pitch ld; every thread starts its copies, then
// waits for them
__device__ __forceinline__ void stage_rows(float* tile, int ld,
                                           const float* dx3, int b0,
                                           int nrows, int t, int T, int H,
                                           int col0, int width) {
  const int w4 = width / 4;
  const size_t H3 = 3 * (size_t)H;
  for (int i = threadIdx.x; i < nrows * w4; i += THREADS) {
    const int r = i / w4, k4 = i % w4;
    const size_t bt = (size_t)(b0 + r) * T + t;
    cp_async16(tile + r * ld + 4 * k4, dx3 + bt * H3 + col0 + 4 * k4);
  }
  cp_async_wait_all();
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
  float* tile = wg_s + U * LDG;         // staged dc_pre or dg rows
  float* dh_s = tile + ROWS * LDG;      // dh carry [B][U]

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const size_t H3 = 3 * (size_t)H;

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
  for (int i = tid; i < B * U; i += THREADS) dh_s[i] = 0.f;
  // the products: KSPLIT adjacent lanes per tile row
  const int d_r = tid / KSPLIT, d_split = tid % KSPLIT;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    // ---- phase 1: dc_pre and dz_pre of this block's units, one thread
    //      per (row, unit)
    for (int i = tid; i < B * U; i += THREADS) {
      const int b = i / U, j = u0 + i % U;
      const size_t bt = (size_t)b * T + t;
      const float m = mask[bt];
      const float dh_t = g_hs[bt * H + j] + dh_s[i];
      const float dh_new = m * dh_t;
      const float* g = gates + bt * H3;
      const float z = g[j], c = g[2 * H + j];
      const float h_prev = prev_state(hs, reset, bt, t, H, j);
      float* out = dx3 + bt * H3;
      out[j] = dh_new * (h_prev - c) * z * (1.f - z);
      out[2 * H + j] = dh_new * (1.f - z) * (1.f - c * c);
      if (t == 0) out[H + j] = 0.f;     // dr_pre: h_prev is zero
      dh_s[i] = dh_new * z + (1.f - m) * dh_t;
    }
    if (t == 0) break;
    grid.sync();        // all of dc_pre[:, t] written before any block reads

    // ---- phase 2: drh = dc_pre @ Wc^T for this block's units, dr_pre
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      const int nrows = min(ROWS, B - b0);
      stage_rows(tile, LDG, dx3, b0, nrows, t, T, H, 2 * H, H);
      __syncthreads();
      float acc[U];
      row_products(tile, LDG, wc_s, LDC, H, d_r, d_split, nrows, acc);
      if (d_split < U && d_r < nrows) {
        const int b = b0 + d_r, j = u0 + d_split;
        const size_t bt = (size_t)b * T + t;
        const float drh = pick(acc, d_split);
        const float r = gates[bt * H3 + H + j];
        const float h_prev = prev_state(hs, reset, bt, t, H, j);
        dx3[bt * H3 + H + j] = drh * h_prev * r * (1.f - r);
        dh_s[b * U + d_split] += drh * r;
      }
      __syncthreads();  // the tile is refilled by the next rows
    }
    grid.sync();        // all of dr_pre[:, t] written before any block reads

    // ---- phase 3: dh += [dz_pre | dr_pre] @ Wg^T, gated by the reset
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      const int nrows = min(ROWS, B - b0);
      stage_rows(tile, LDG, dx3, b0, nrows, t, T, H, 0, 2 * H);
      __syncthreads();
      float acc[U];
      row_products(tile, LDG, wg_s, LDG, 2 * H, d_r, d_split, nrows, acc);
      if (d_split < U && d_r < nrows) {
        const int b = b0 + d_r;
        float v = dh_s[b * U + d_split] + pick(acc, d_split);
        if (reset != nullptr) v *= 1.f - reset[(size_t)b * T + t];
        dh_s[b * U + d_split] = v;
      }
      __syncthreads();  // the tile is refilled; the carry read next step
    }
  }
}

// ---- gru_bwd_dw: 3xTF32 mma.sync, the pair reduction split over the grid --

constexpr int DW_TILE = 64;          // output tile: 64 rows k x 64 columns j
constexpr int DW_THREADS = 128;      // 4 warps, each a 32 x 32 quarter
constexpr int DW_CH = 32;            // (row, step) pairs a staged chunk
constexpr int DW_NS = 2;             // stages of the cp.async ring
constexpr int DW_LD = DW_TILE + 8;   // row of a staged tile: 8 mod 32
constexpr int DW_TILE_F = DW_CH * DW_LD;
// a stage: h_prev's rows, r's rows and dx3's columns of the chunk's pairs
// ([DW_CH][DW_LD] each), then their reset values
constexpr int DW_STAGE = 3 * DW_TILE_F + DW_CH;
constexpr int DW_SMEM = DW_NS * DW_STAGE * 4;
constexpr int DW_COPIES = DW_CH * DW_TILE / 4 / DW_THREADS;  // 16-byte
static_assert(DW_COPIES == 4, "a thread copies 4 rows of 4 floats");

// The partials' sum: one float4 (float where the pointers or the count do
// not allow it) a thread, SUM_GROUP partials loaded before their adds
constexpr int SUM_THREADS = 128;
constexpr int SUM_GROUP = 16;
constexpr size_t SUM_MAX_BLOCKS = 32 * 132;  // beyond that the grid strides

// cp_async16 (above, with its zero fill), cp_async4, split_big, mma_tf32
// and mma_3xtf32 are copies of csrc/vocab_xent.cu's: each library is
// built from its one .cu file.

// cp.async of 4 bytes, zero-filled where `ok` is false
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// a = big + small: big = a with its low 13 mantissa bits cleared (TF32,
// truncated), small = a - big exact in float32 (the tensor cores read its
// top 10 mantissa bits, an error of the order of the dropped small·small
// term)
__device__ __forceinline__ void split_big(float a, unsigned& big,
                                          unsigned& small) {
  big = __float_as_uint(a) & 0xFFFFE000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

// c += a @ b on one 16 x 8 x 8 tile. Fragments (g = lane / 4, t = lane % 4):
// a[0..3] = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]; b[0..1] = B[t][g],
// B[t+4][g]; c[0..3] = C[g][2t], C[g][2t+1], C[g+8][2t], C[g+8][2t+1]
__device__ __forceinline__ void mma_tf32(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a @ b in three TF32 passes, the small terms first: big·small,
// small·big, big·big (small·small, some 2^-22 of the product, is dropped)
__device__ __forceinline__ void mma_3xtf32(float c[4], const unsigned ab[4],
                                           const unsigned as[4],
                                           const unsigned bb[2],
                                           const unsigned bs[2]) {
  mma_tf32(c, ab, bs);
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bb);
}

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

// acc += the staged chunk's A^T D for the warp's 32 x 32 quarter of the
// tile (rows k, columns j): 2 x 4 tiles of 16 x 8, four depth steps of 8
// pairs. A = h_prev * (1 - reset), times r for dWc, formed in float32 as
// the fragments are read; D = dx3's columns. The chunk's sum forms in
// fresh accumulators and is added to acc in float32: the tensor cores
// truncate each MMA's float32 sum, so sums kept inside the MMAs over
// thousands of pairs would drift by up to an ulp for every 8 pairs
template <bool CAND, bool RESET>
__device__ __forceinline__ void dw_chunk(const float* st,
                                         float acc[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 1) * 32 + g, n0 = (warp & 1) * 32 + g;
  const float* hsm = st;
  const float* rsm = st + DW_TILE_F;
  const float* dsm = st + 2 * DW_TILE_F;
  const float* psm = st + 3 * DW_TILE_F;
  float part[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DW_CH; kk += 8) {
    const int p0 = kk + t, p1 = p0 + 4;  // the lane's two pairs
    const float f0 = RESET ? 1.f - psm[p0] : 1.f;
    const float f1 = RESET ? 1.f - psm[p1] : 1.f;
    unsigned ab[2][4], as[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = m0 + mt * 16;
      const int at[4] = {p0 * DW_LD + m, p0 * DW_LD + m + 8, p1 * DW_LD + m,
                         p1 * DW_LD + m + 8};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float a = hsm[at[e]];
        if (RESET) a *= e < 2 ? f0 : f1;
        if (CAND) a = rsm[at[e]] * a;
        split_big(a, ab[mt][e], as[mt][e]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + nt * 8;
      unsigned bb[2], bs[2];
      split_big(dsm[p0 * DW_LD + n], bb[0], bs[0]);
      split_big(dsm[p1 * DW_LD + n], bb[1], bs[1]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        mma_3xtf32(part[mt][nt], ab[mt], as[mt], bb, bs);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
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

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }

__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// out = the S partials [S][total] summed in split order, SUM_GROUP loads
// in flight before their adds; V float4 where total counts float4s
template <typename V>
__global__ void __launch_bounds__(SUM_THREADS)
gru_bwd_dw_reduce_kernel(const V* __restrict__ part, V* __restrict__ out,
                         size_t total, int S) {
  for (size_t i = blockIdx.x * (size_t)SUM_THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * SUM_THREADS) {
    V v = part[i];
    for (int s0 = 1; s0 < S; s0 += SUM_GROUP) {
      V u[SUM_GROUP];
#pragma unroll
      for (int k = 0; k < SUM_GROUP; ++k)
        if (s0 + k < S) u[k] = part[(size_t)(s0 + k) * total + i];
#pragma unroll
      for (int k = 0; k < SUM_GROUP; ++k)
        if (s0 + k < S) add_to(v, u[k]);
    }
    out[i] = v;
  }
}

// on the calling thread's current device, which the wrapper sets
cudaError_t prepare(int B, int H) {
  return cudaFuncSetAttribute(gru_bwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(B, H));
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
  if (total < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const bool vec = total % 4 == 0 && ((uintptr_t)part & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const size_t n = vec ? total / 4 : total;
  size_t blocks = (n + SUM_THREADS - 1) / SUM_THREADS;
  if (blocks > SUM_MAX_BLOCKS) blocks = SUM_MAX_BLOCKS;
  if (vec)
    gru_bwd_dw_reduce_kernel<float4><<<(unsigned)blocks, SUM_THREADS, 0,
                                       (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
        n, S);
  else
    gru_bwd_dw_reduce_kernel<float><<<(unsigned)blocks, SUM_THREADS, 0,
                                      (cudaStream_t)stream>>>(part, out, n,
                                                              S);
  return (int)cudaGetLastError();
}

const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* gru_bwd_dw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* gru_bwd_dw_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
