// Fused GRU backward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/gru.py `_bwd_kernel` (launched by
// `_bwd_call`), the Pallas TPU kernel that walks the GRU recurrence in
// reverse over the forward's z|r|c stash and accumulates dWg, dWc and the
// bias gradient in the kernel. Here that work is two kernels:
//   gru_bwd     the reverse recurrence: dx3 = [dz_pre | dr_pre | dc_pre];
//   gru_bwd_dw  dWg, dWc and db from dx3, the stash and hs, launched once
//               after it (a reduction over every (row, step) pair; dx3 is
//               zero at padded steps, so they add nothing).
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
// dh products are 2*B*T*(H*H + 2H*H) flops (10.1 GFLOP), the dW products
// as much again; each 0.15 ms on the float32 CUDA cores at 67 TFLOP/s. The
// bytes (stash, dx3, hs, g_hs: 8H floats per (row, step), about 105 MB)
// take about 0.03 ms at 3.35 TB/s. So operations bound both, and the time
// loop of gru_bwd is serial: each step needs all of step t+1's dh.
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
// Design of gru_bwd_dw. An output-stationary tiled product in float32 on
// the CUDA cores: a block owns a 64 x 64 tile of [dWg | dWc] (rows k,
// columns j of one of the two), walks the B*T (row, step) pairs in chunks
// of 32, staging h_prev (times r for dWc) and dx3's columns in shared
// memory with the next chunk's loads already in registers, and each
// thread sums a 4 x 4 block of outputs. The blocks of the first row tile
// also sum db's columns. Every output element is summed by one thread in
// a fixed order: no atomics, the same bits in every run.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

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

// 16 bytes global -> shared without a register round trip, cached in L2
// only (.cg): the source was written by another block during this launch
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
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

// ---- gru_bwd_dw ------------------------------------------------------------

constexpr int DW_TILE = 64;             // output tile: 64 rows k x 64 cols j
constexpr int DW_CHUNK = 32;            // (row, step) pairs per staged chunk
constexpr int DW_THREADS = 256;         // 16 x 16 threads of 4 x 4 outputs
constexpr int DW_LOADS = DW_CHUNK * DW_TILE / 4 / DW_THREADS;  // float4s
static_assert(DW_LOADS == 2, "each thread stages 2 float4 per operand");

// h_prev (times r for dWc) at pair n = b*T + t, columns [k, k+4); zero
// outside the data
__device__ __forceinline__ float4 dw_load_a(const float* reset,
                                            const float* gates,
                                            const float* hs, size_t n,
                                            size_t N, int k, int T, int H,
                                            bool cand) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (n >= N || k >= H || n % T == 0) return v;
  v = *reinterpret_cast<const float4*>(hs + (n - 1) * H + k);
  float p = reset != nullptr ? 1.f - reset[n] : 1.f;
  if (cand) {
    const float4 r =
        *reinterpret_cast<const float4*>(gates + n * 3 * H + H + k);
    v.x *= r.x; v.y *= r.y; v.z *= r.z; v.w *= r.w;
  }
  v.x *= p; v.y *= p; v.z *= p; v.w *= p;
  return v;
}

// dx3 at pair n, columns [col_off + j, +4) (j within the part's width)
__device__ __forceinline__ float4 dw_load_d(const float* dx3, size_t n,
                                            size_t N, int j, int width,
                                            int col_off, int H) {
  if (n >= N || j >= width) return make_float4(0.f, 0.f, 0.f, 0.f);
  return *reinterpret_cast<const float4*>(dx3 + n * 3 * H + col_off + j);
}

__global__ void __launch_bounds__(DW_THREADS)
gru_bwd_dw_kernel(const float* __restrict__ reset,
                  const float* __restrict__ gates,
                  const float* __restrict__ hs,
                  const float* __restrict__ dx3, float* __restrict__ dwg,
                  float* __restrict__ dwc, float* __restrict__ db, int B,
                  int T, int H) {
  __shared__ __align__(16) float a_s[DW_CHUNK][DW_TILE];  // a_s[n][k]
  __shared__ __align__(16) float d_s[DW_CHUNK][DW_TILE];  // d_s[n][j]
  const int n_wg = (2 * H + DW_TILE - 1) / DW_TILE;
  const bool cand = (int)blockIdx.x >= n_wg;   // the dWc part
  const int j0 = (cand ? blockIdx.x - n_wg : blockIdx.x) * DW_TILE;
  const int width = cand ? H : 2 * H;
  const int col_off = cand ? 2 * H : 0;
  const int k0 = blockIdx.y * DW_TILE;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int ld_n = tid / 16, ld_c = 4 * (tid % 16);
  const size_t N = (size_t)B * T;
  const bool sums_db = blockIdx.y == 0 && tid < DW_TILE;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;
  float colsum = 0.f;

  float4 ra[DW_LOADS], rd[DW_LOADS];
#pragma unroll
  for (int q = 0; q < DW_LOADS; ++q) {
    const size_t n = ld_n + 16 * q;
    ra[q] = dw_load_a(reset, gates, hs, n, N, k0 + ld_c, T, H, cand);
    rd[q] = dw_load_d(dx3, n, N, j0 + ld_c, width, col_off, H);
  }
  for (size_t c0 = 0; c0 < N; c0 += DW_CHUNK) {
#pragma unroll
    for (int q = 0; q < DW_LOADS; ++q) {
      *reinterpret_cast<float4*>(&a_s[ld_n + 16 * q][ld_c]) = ra[q];
      *reinterpret_cast<float4*>(&d_s[ld_n + 16 * q][ld_c]) = rd[q];
    }
    __syncthreads();
    // the next chunk's loads in flight while this one is summed
#pragma unroll
    for (int q = 0; q < DW_LOADS; ++q) {
      const size_t n = c0 + DW_CHUNK + ld_n + 16 * q;
      ra[q] = dw_load_a(reset, gates, hs, n, N, k0 + ld_c, T, H, cand);
      rd[q] = dw_load_d(dx3, n, N, j0 + ld_c, width, col_off, H);
    }
#pragma unroll 8
    for (int n = 0; n < DW_CHUNK; ++n) {
      const float4 a = *reinterpret_cast<const float4*>(&a_s[n][4 * ty]);
      const float4 d = *reinterpret_cast<const float4*>(&d_s[n][4 * tx]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float dv[4] = {d.x, d.y, d.z, d.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          acc[i][jj] = fmaf(av[i], dv[jj], acc[i][jj]);
    }
    if (sums_db)
      for (int n = 0; n < DW_CHUNK; ++n) colsum += d_s[n][tid];
    __syncthreads();    // a_s and d_s are refilled next chunk
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + 4 * ty + i;
    if (k >= H) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int j = j0 + 4 * tx + jj;
      if (j >= width) continue;
      if (cand)
        dwc[(size_t)k * H + j] = acc[i][jj];
      else
        dwg[(size_t)k * 2 * H + j] = acc[i][jj];
    }
  }
  if (sums_db && j0 + tid < width) db[col_off + j0 + tid] = colsum;
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

// Launches the dW / db reduction on `stream` of the current device (an
// ordinary launch: its blocks need not be co-resident); returns the
// cudaError_t of the launch. `reset` may be NULL.
int gru_bwd_dw(const float* reset, const float* gates, const float* hs,
               const float* dx3, float* dwg, float* dwc, float* db, int B,
               int T, int H, void* stream) {
  const int n_wg = (2 * H + DW_TILE - 1) / DW_TILE;
  const int n_wc = (H + DW_TILE - 1) / DW_TILE;
  const int n_k = (H + DW_TILE - 1) / DW_TILE;
  gru_bwd_dw_kernel<<<dim3(n_wg + n_wc, n_k), DW_THREADS, 0,
                      (cudaStream_t)stream>>>(reset, gates, hs, dx3, dwg,
                                              dwc, db, B, T, H);
  return (int)cudaGetLastError();
}

const char* gru_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* gru_bwd_dw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
