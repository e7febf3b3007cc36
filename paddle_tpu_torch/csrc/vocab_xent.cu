// Fused vocabulary projection + softmax cross-entropy for Hopper (sm_90a):
// the forward and its two backward products, bound to Python through
// ctypes. No [N, V] logits buffer is ever written to device memory.
//
// Replaces: paddle_tpu/kernels/vocab_xent.py `_fwd_kernel` (:56, launched
// by `_fwd`), `_bwd_dx_kernel` (:91) and `_bwd_dw_kernel` (:116, both
// launched by `_vjp_bwd`), the Pallas TPU kernels that recompute the
// logits x @ w + b chunk by chunk in VMEM. Here that work is five kernels:
//   vocab_xent_fwd            per (row tile, vocabulary slice): the online
//                             (max, sumexp, gold) of each row over the
//                             slice's columns -> partials [3, S, N];
//   vocab_xent_fwd_reduce     per row, the S partials combined in slice
//                             order -> lse, nll [N];
//   vocab_xent_bwd_dx         per (row tile, slice): dx partials [S, N, D]
//                             of dlog @ w^T over the slice's columns;
//   vocab_xent_bwd_dx_reduce  dx [N, D], the S partials summed in order;
//   vocab_xent_bwd_dw         per column tile, over all rows: dW [D, V]
//                             and db [V].
//
// What they compute, with logits = x @ w + b over the columns c < V:
//   lse[r]  = m + log(max(l, 1e-30)), m = max_c logits[r, c],
//             l = sum_c exp(logits[r, c] - m)  (online over column tiles)
//   nll[r]  = lse[r] - gold[r], gold = logits[r, label[r]] if 0 <= label[r]
//             < V, else 0 (the TPU's one-hot matches no column)
//   dlog    = (exp(logits - lse[r]) - onehot(label[r])) * ct[r]
//   dx      = dlog @ w^T,  dW = x^T @ dlog,  db = sum_rows dlog
// Labels arrive as int32, out-of-range ones already -1: no kernel indexes
// w or the logits with a label, it only compares column numbers with it.
// Nothing is padded: rows >= N, columns >= V and depths >= D read as 0 and
// are masked out of every max, sum and store, so a bias of 100 meets no
// padded row's lse and no inf * 0 arises. The TPU's +1e4 lse guard of
// padded rows has nothing to guard here.
//
// Layout: x [N, D], w [D, V] (row-major), b, lse, ct and labels as given,
// dx [N, D], dW [D, V], db [V]. All float32, all contiguous; any N, D,
// V >= 1.
//
// Bound on an H100 SXM at the NMT output projection, N = 7680 (256 x 30),
// D = 512, V = 30000: the forward's product is 2NDV = 235.9 GFLOP, 3.52 ms
// at 67 TFLOP/s (float32 outside the tensor cores), against 77 MB of
// inputs, 0.023 ms at 3.35 TB/s; each backward kernel recomputes the
// logits and forms one more product of the same size, 471.9 GFLOP, 7.04
// ms. The N*V exponentials (0.23 G) add under 1%. Operations bound all
// three.
//
// Design. The TPU carries (m, l, gold) and the dx accumulator across a
// sequential V grid axis; on Hopper blocks run in parallel in no order.
// Every kernel is built from one shared-memory-tiled float32 product: a
// tile of 64 rows x 128 columns, 256 threads each holding a 4 x 8 block of
// sums in registers, depth steps of 16 staged in shared memory with the
// next step's loads in flight in registers (two buffers, one barrier a
// step), all on the CUDA cores in full float32 FMA (no TF32, no library
// GEMM), so the plain version's arithmetic and the CPU's agree with it.
// Each thread's 8 columns are two runs of 4 (tx*4 and 64 + tx*4) and its
// rows one run of 4, read from shared memory as float4s.
//   fwd:  a block owns 64 rows and one of S slices of the column tiles and
//         loops over them, updating each row's (m, l, gold) online; the 16
//         threads sharing a row reduce by xor shuffles (every lane ends
//         with the same value). S is chosen by the wrapper for some 16
//         blocks an SM; a second small kernel combines the slices in order.
//         At (7680, 512, 30000) on an H100 80GB HBM3 at 700 W, S = 17
//         takes 7.49 ms with its combine, S = 1 (120 blocks, one an SM)
//         12.00 ms, S = 2 to 8 7.94 to 7.99 ms
//         (tools/torch_vocab_xent_slices.py).
//   dx:   a block owns 64 rows and one slice; per column tile it writes
//         dlog [128, 64] (column-major) to shared memory and adds dlog @
//         w_tile^T into its slice's partial dx, 128 columns of D at a time,
//         read-modify-written through L2. S (some 2 blocks an SM) bounds
//         the partials' memory; a second kernel sums them in slice order.
//         At the same shape and card S = 2 takes 18.52 ms with its sum
//         (0.04 ms), S = 1 24.16 ms, S = 3 to 6 18.34 to 19.49 ms.
//   dw:   a block owns 128 columns and loops over all row tiles in order;
//         per tile it writes dlog [64, 128] to shared memory, adds x_tile^T
//         @ dlog into its dW columns (64 rows of D at a time, read-modify-
//         written through L2) and sums db's column in a fixed order.
// No atomics anywhere: two runs give the same bits. Shared memory: 25 KB
// (fwd), 75 KB (dx), 58 KB (dw); expf and logf are the accurate ones.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int BM = 64;          // rows of x a tile
constexpr int BN = 128;         // vocabulary columns a tile
constexpr int BK = 16;          // depth of one staged step
constexpr int THREADS = 256;
constexpr int AP = BM + 4;      // padded row of a k-major [BK][BM] tile
constexpr int WP = BN + 4;      // padded row of a [.][BN] tile
constexpr int DXC = 128;        // columns of dx a chunk
constexpr int DWC = 64;         // rows of dW a chunk

typedef float ATile[BK][AP];
typedef float BTile[BK][BN];
typedef float WTile[BK][WP];

constexpr int DX_SMEM = (2 * BK * AP + 2 * BK * BN + 2 * BK * WP + BN * AP) * 4;
constexpr int DW_SMEM = (2 * BK * AP + 2 * BK * BN + BM * WP) * 4;

// the thread's j-th column (of 8) within a 128-column tile
__device__ __forceinline__ int col_of(int tx, int j) {
  return (j < 4 ? 0 : 64) + tx * 4 + (j & 3);
}

__device__ __forceinline__ void fma_step(float acc[4][8], float4 a, float4 b0,
                                         float4 b1) {
  const float av[4] = {a.x, a.y, a.z, a.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// acc[i][j] = sum_k x[r0 + ty*4 + i][k] * w[k][c0 + col_of(tx, j)], k < D;
// rows >= N, columns >= V and depths >= D read as 0
__device__ void logits_tile(const float* __restrict__ x,
                            const float* __restrict__ w, int N, int D, int V,
                            int r0, int c0, ATile* as, BTile* bs,
                            float acc[4][8]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float ra[4], rb[8];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * THREADS, r = r0 + (e >> 4), k = k0 + (e & 15);
      ra[q] = (r < N && k < D) ? x[(size_t)r * D + k] : 0.f;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = tid + q * THREADS, k = k0 + (e >> 7), c = c0 + (e & 127);
      rb[q] = (k < D && c < V) ? w[(size_t)k * V + c] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * THREADS;
      as[buf][e & 15][e >> 4] = ra[q];
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = tid + q * THREADS;
      bs[buf][e >> 7][e & 127] = rb[q];
    }
  };
  const int nk = (D + BK - 1) / BK;
  __syncthreads();  // the buffers' last readers are done
  load(0);
  store(0);
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk)
      fma_step(acc, *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]),
               *reinterpret_cast<const float4*>(&bs[cur][kk][tx * 4]),
               *reinterpret_cast<const float4*>(&bs[cur][kk][64 + tx * 4]));
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
}

// acc[i][j] += sum_{k < BN} dl[k][ty*4 + i] * w[d0 + col_of(tx, j)][c0 + k]:
// the dlog tile (k-major, [BN][AP]) times the column tile of w transposed;
// depths d >= D and columns >= V read as 0
__device__ void dx_chunk(const float* __restrict__ w, int D, int V, int c0,
                         int d0, const float* dl, WTile* wt,
                         float acc[4][8]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float rb[8];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = tid + q * THREADS, c = c0 + k0 + (e & 15), d = d0 + (e >> 4);
      rb[q] = (d < D && c < V) ? w[(size_t)d * V + c] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int e = tid + q * THREADS;
      wt[buf][e & 15][e >> 4] = rb[q];
    }
  };
  constexpr int nk = BN / BK;
  __syncthreads();
  load(0);
  store(0);
  __syncthreads();
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk)
      fma_step(acc,
               *reinterpret_cast<const float4*>(&dl[(kt * BK + kk) * AP + ty * 4]),
               *reinterpret_cast<const float4*>(&wt[cur][kk][tx * 4]),
               *reinterpret_cast<const float4*>(&wt[cur][kk][64 + tx * 4]));
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
}

// acc[i][j] += sum_{k < BM} x[r0 + k][d0 + ty*4 + i] * dl[k][col_of(tx, j)]:
// the row tile of x transposed times the dlog tile ([BM][WP]); rows >= N
// and depths d >= D read as 0
__device__ void dw_chunk(const float* __restrict__ x, int N, int D, int r0,
                         int d0, const float* dl, ATile* as,
                         float acc[4][8]) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  float ra[4];
  auto load = [&](int k0) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * THREADS, r = r0 + k0 + (e >> 6), d = d0 + (e & 63);
      ra[q] = (r < N && d < D) ? x[(size_t)r * D + d] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int e = tid + q * THREADS;
      as[buf][e >> 6][e & 63] = ra[q];
    }
  };
  constexpr int nk = BM / BK;
  __syncthreads();
  load(0);
  store(0);
  __syncthreads();
#pragma unroll 1
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) load((kt + 1) * BK);
#pragma unroll
    for (int kk = 0; kk < BK; ++kk)
      fma_step(acc, *reinterpret_cast<const float4*>(&as[cur][kk][ty * 4]),
               *reinterpret_cast<const float4*>(&dl[(kt * BK + kk) * WP + tx * 4]),
               *reinterpret_cast<const float4*>(
                   &dl[(kt * BK + kk) * WP + 64 + tx * 4]));
    if (kt + 1 < nk) store(cur ^ 1);
    __syncthreads();
  }
}

// the column tiles [lo, hi) of slice s of S over nvt tiles
__device__ __forceinline__ void slice_tiles(int nvt, int S, int s, int& lo,
                                            int& hi) {
  lo = (int)((long long)s * nvt / S);
  hi = (int)((long long)(s + 1) * nvt / S);
}

// the tile's columns: whether each of the thread's 8 is < V, and its bias
__device__ __forceinline__ void tile_columns(const float* __restrict__ b,
                                             int V, int c0, bool valid[8],
                                             float bias[8]) {
  const int tx = threadIdx.x & 15;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = c0 + col_of(tx, j);
    valid[j] = c < V;
    bias[j] = valid[j] ? b[c] : 0.f;
  }
}

// dlog of the thread's 4 x 8 block: (exp(logits - lse) - onehot) * ct,
// exactly 0 at rows >= N and columns >= V (a select: a row past N has no
// lse, and exp(bias) there may be inf); acc holds x @ w without the bias
__device__ __forceinline__ void dlog_block(float acc[4][8], const bool valid[8],
                                           const float bias[8], int r0,
                                           int c0, int N, const int lab[4],
                                           const float lse[4],
                                           const float ct[4]) {
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = c0 + col_of(tx, j);
      const float p = expf(acc[i][j] + bias[j] - lse[i]);
      acc[i][j] = (valid[j] && r0 + ty * 4 + i < N)
                      ? (p - (c == lab[i] ? 1.f : 0.f)) * ct[i]
                      : 0.f;
    }
}

__global__ void __launch_bounds__(THREADS, 2)
vocab_xent_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, const int* __restrict__ lab,
                      float* __restrict__ part, int N, int D, int V, int S) {
  __shared__ __align__(16) float as[2][BK][AP];
  __shared__ __align__(16) float bs[2][BK][BN];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * BM, s = blockIdx.y;
  int lo, hi;
  slice_tiles((V + BN - 1) / BN, S, s, lo, hi);
  int lab_r[4];
  float m_run[4], l_run[4], g_run[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    lab_r[i] = r < N ? lab[r] : -1;
    m_run[i] = NEG;
    l_run[i] = 0.f;
    g_run[i] = 0.f;
  }
  for (int t = lo; t < hi; ++t) {
    const int c0 = t * BN;
    float acc[4][8];
    logits_tile(x, w, N, D, V, r0, c0, as, bs, acc);
    bool valid[8];
    float bias[8];
    tile_columns(b, V, c0, valid, bias);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[i][j] += bias[j];
        if (valid[j]) mx = fmaxf(mx, acc[i][j]);
      }
      const float m_new = fmaxf(m_run[i], half_warp_max(mx));
      float sum = 0.f, gold = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (!valid[j]) continue;
        sum += expf(acc[i][j] - m_new);
        if (c0 + col_of(tx, j) == lab_r[i]) gold += acc[i][j];
      }
      sum = half_warp_sum(sum);
      gold = half_warp_sum(gold);
      l_run[i] = l_run[i] * expf(m_run[i] - m_new) + sum;
      m_run[i] = m_new;
      g_run[i] += gold;
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      if (r >= N) continue;
      part[((size_t)0 * S + s) * N + r] = m_run[i];
      part[((size_t)1 * S + s) * N + r] = l_run[i];
      part[((size_t)2 * S + s) * N + r] = g_run[i];
    }
  }
}

__global__ void vocab_xent_fwd_reduce_kernel(const float* __restrict__ part,
                                             float* __restrict__ nll,
                                             float* __restrict__ lse, int N,
                                             int S) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= N) return;
  float m = NEG;
  for (int s = 0; s < S; ++s) m = fmaxf(m, part[(size_t)s * N + r]);
  float l = 0.f, g = 0.f;
  for (int s = 0; s < S; ++s) {
    l += part[((size_t)S + s) * N + r] * expf(part[(size_t)s * N + r] - m);
    g += part[((size_t)2 * S + s) * N + r];
  }
  const float z = m + logf(fmaxf(l, 1e-30f));
  lse[r] = z;
  nll[r] = z - g;
}

__global__ void __launch_bounds__(THREADS, 2)
vocab_xent_bwd_dx_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ b,
                         const int* __restrict__ lab,
                         const float* __restrict__ lse,
                         const float* __restrict__ ct,
                         float* __restrict__ part, int N, int D, int V,
                         int S) {
  extern __shared__ __align__(16) float smem[];
  ATile* as = reinterpret_cast<ATile*>(smem);
  BTile* bs = reinterpret_cast<BTile*>(smem + 2 * BK * AP);
  WTile* wt = reinterpret_cast<WTile*>(smem + 2 * BK * AP + 2 * BK * BN);
  float* dl = smem + 2 * BK * AP + 2 * BK * BN + 2 * BK * WP;  // [BN][AP]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int r0 = blockIdx.x * BM, s = blockIdx.y;
  int lo, hi;
  slice_tiles((V + BN - 1) / BN, S, s, lo, hi);
  int lab_r[4];
  float lse_r[4], ct_r[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    lab_r[i] = r < N ? lab[r] : -1;
    lse_r[i] = r < N ? lse[r] : 0.f;
    ct_r[i] = r < N ? ct[r] : 0.f;
  }
  float* out = part + (size_t)s * N * D;
  for (int t = lo; t < hi; ++t) {
    const int c0 = t * BN;
    float acc[4][8];
    logits_tile(x, w, N, D, V, r0, c0, as, bs, acc);
    bool valid[8];
    float bias[8];
    tile_columns(b, V, c0, valid, bias);
    dlog_block(acc, valid, bias, r0, c0, N, lab_r, lse_r, ct_r);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<float4*>(&dl[col_of(tx, j) * AP + ty * 4]) =
          make_float4(acc[0][j], acc[1][j], acc[2][j], acc[3][j]);
    __syncthreads();
    for (int d0 = 0; d0 < D; d0 += DXC) {
      float sum[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r0 + ty * 4 + i, d = d0 + col_of(tx, j);
          sum[i][j] = (t > lo && r < N && d < D) ? out[(size_t)r * D + d] : 0.f;
        }
      dx_chunk(w, D, V, c0, d0, dl, wt, sum);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int r = r0 + ty * 4 + i, d = d0 + col_of(tx, j);
          if (r < N && d < D) out[(size_t)r * D + d] = sum[i][j];
        }
    }
  }
}

__global__ void vocab_xent_bwd_dx_reduce_kernel(const float* __restrict__ part,
                                                float* __restrict__ dx,
                                                size_t total, int S) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < total;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = part[i];
    for (int s = 1; s < S; ++s) v += part[(size_t)s * total + i];
    dx[i] = v;
  }
}

__global__ void __launch_bounds__(THREADS, 2)
vocab_xent_bwd_dw_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ b,
                         const int* __restrict__ lab,
                         const float* __restrict__ lse,
                         const float* __restrict__ ct, float* __restrict__ dw,
                         float* __restrict__ db, int N, int D, int V) {
  extern __shared__ __align__(16) float smem[];
  ATile* as = reinterpret_cast<ATile*>(smem);
  BTile* bs = reinterpret_cast<BTile*>(smem + 2 * BK * AP);
  float* dl = smem + 2 * BK * AP + 2 * BK * BN;  // [BM][WP]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int c0 = blockIdx.x * BN;
  bool valid[8];
  float bias[8];
  tile_columns(b, V, c0, valid, bias);
  float db_run = 0.f;  // column c0 + tid, for tid < BN
  const int nrt = (N + BM - 1) / BM;
  for (int rt = 0; rt < nrt; ++rt) {
    const int r0 = rt * BM;
    int lab_r[4];
    float lse_r[4], ct_r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + ty * 4 + i;
      lab_r[i] = r < N ? lab[r] : -1;
      lse_r[i] = r < N ? lse[r] : 0.f;
      ct_r[i] = r < N ? ct[r] : 0.f;
    }
    float acc[4][8];
    logits_tile(x, w, N, D, V, r0, c0, as, bs, acc);
    dlog_block(acc, valid, bias, r0, c0, N, lab_r, lse_r, ct_r);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* row = &dl[(ty * 4 + i) * WP];
      *reinterpret_cast<float4*>(&row[tx * 4]) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      *reinterpret_cast<float4*>(&row[64 + tx * 4]) =
          make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
    }
    __syncthreads();
    if (tid < BN) {
      float colsum = 0.f;
      for (int r = 0; r < BM; ++r) colsum += dl[r * WP + tid];
      db_run += colsum;
    }
    for (int d0 = 0; d0 < D; d0 += DWC) {
      float sum[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = d0 + ty * 4 + i, c = c0 + col_of(tx, j);
          sum[i][j] = (rt > 0 && d < D && c < V) ? dw[(size_t)d * V + c] : 0.f;
        }
      dw_chunk(x, N, D, r0, d0, dl, as, sum);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int d = d0 + ty * 4 + i, c = c0 + col_of(tx, j);
          if (d < D && c < V) dw[(size_t)d * V + c] = sum[i][j];
        }
    }
  }
  if (tid < BN && c0 + tid < V) db[c0 + tid] = db_run;
}

bool sizes_ok(int N, int D, int V, int S) {
  const int nvt = (V + BN - 1) / BN;
  return N >= 1 && D >= 1 && V >= 1 && S >= 1 && S <= nvt && S <= 65535;
}

}  // namespace

extern "C" {

// Each launches on `stream` of the current device and returns the
// cudaError_t of the launch (0 on success). S is the number of
// vocabulary slices of the forward and dx kernels' partials.

int vocab_xent_fwd(const float* x, const float* w, const float* b,
                   const int* lab, float* part, int N, int D, int V, int S,
                   void* stream) {
  if (!sizes_ok(N, D, V, S)) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BM - 1) / BM, S);
  vocab_xent_fwd_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      x, w, b, lab, part, N, D, V, S);
  return (int)cudaGetLastError();
}

int vocab_xent_fwd_reduce(const float* part, float* nll, float* lse, int N,
                          int S, void* stream) {
  if (N < 1 || S < 1) return (int)cudaErrorInvalidValue;
  vocab_xent_fwd_reduce_kernel<<<(N + 255) / 256, 256, 0,
                                 (cudaStream_t)stream>>>(part, nll, lse, N, S);
  return (int)cudaGetLastError();
}

int vocab_xent_bwd_dx(const float* x, const float* w, const float* b,
                      const int* lab, const float* lse, const float* ct,
                      float* part, int N, int D, int V, int S, void* stream) {
  if (!sizes_ok(N, D, V, S)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      vocab_xent_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BM - 1) / BM, S);
  vocab_xent_bwd_dx_kernel<<<grid, THREADS, DX_SMEM, (cudaStream_t)stream>>>(
      x, w, b, lab, lse, ct, part, N, D, V, S);
  return (int)cudaGetLastError();
}

int vocab_xent_bwd_dx_reduce(const float* part, float* dx, int N, int D,
                             int S, void* stream) {
  if (N < 1 || D < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)N * D;
  const size_t blocks = (total + 255) / 256;
  vocab_xent_bwd_dx_reduce_kernel<<<(unsigned)(blocks < 65536 ? blocks : 65536),
                                    256, 0, (cudaStream_t)stream>>>(
      part, dx, total, S);
  return (int)cudaGetLastError();
}

int vocab_xent_bwd_dw(const float* x, const float* w, const float* b,
                      const int* lab, const float* lse, const float* ct,
                      float* dw, float* db, int N, int D, int V,
                      void* stream) {
  if (!sizes_ok(N, D, V, 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      vocab_xent_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  vocab_xent_bwd_dw_kernel<<<(V + BN - 1) / BN, THREADS, DW_SMEM,
                             (cudaStream_t)stream>>>(x, w, b, lab, lse, ct,
                                                     dw, db, N, D, V);
  return (int)cudaGetLastError();
}

const char* vocab_xent_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* vocab_xent_fwd_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* vocab_xent_bwd_dx_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* vocab_xent_bwd_dx_reduce_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* vocab_xent_bwd_dw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
