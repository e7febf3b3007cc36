// Fused LSTM backward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/lstm.py `_bwd_kernel` (launched by
// `_bwd_call`), the Pallas TPU kernel that walks the recurrence in reverse
// over the forward's gate stash and accumulates dW and the bias gradient
// in the kernel; and `_bwd_kernel_nodw` (launched by `_bwd_call_nodw`),
// its split form that writes dpre only, dW and db being one matmul and a
// few reductions outside. Here both are one template: lstm_bwd (DW=true)
// and lstm_bwd_nodw (DW=false).
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
// DW also forms dW = sum_t h_prev_t^T @ dpre_t and
// db = [sum dpre | sum di*c_prev | sum df*c_prev | sum do*c].
//
// Layout: batch-major, as the forward: gates [B, T, 4H] (post-activation
// i, f, g, o, written by lstm_fwd at every step, padded ones too, so the
// products below never meet uninitialised memory), hs and cs [B, T, H],
// g_hs and g_cs [B, T, H] (g_cs may be NULL: zero), mask and reset [B, T]
// (reset may be NULL), W [H, 4H], bias [7H]; out dx4 [B, T, 4H], dW
// [H, 4H] and db [7H] (DW only). All float32, all contiguous.
//
// Bound on an H100 SXM at B=64, T=100, H=512: the dh product dpre @ W^T is
// 2*B*T*4H*H flops (13.4 GFLOP), the dW product the same again: 26.8
// GFLOP with DW, 0.40 ms on the float32 CUDA cores at 67 TFLOP/s (0.20 ms
// without). The bytes it must move (gates, dx4, hs, cs, g_hs, g_cs: about
// 13H floats per (row, step), some 170 MB) take about 0.05 ms at 3.35 TB/s.
// So operations bound it, and the time loop is serial.
//
// Design. As in the forward, block j owns hidden units [4j, 4j+4): it
// keeps W's 4 ROWS for them (4 x 4H floats, 32 KB at H=512) in shared
// memory, because the dh product contracts over 4H: dh[b, u] = dpre[b, :]
// . W[u, :]. Each step, per tile of ROWS batch rows, a block
//   1. stages dpre_{t+1} (written by every block into dx4[:, t+1] during
//      the previous step) into shared memory with cp.async.cg (L2 only,
//      every copy of a thread in flight at once), and forms the dh carry
//      for its units: 16 lanes share a row, each summing all 4 units over
//      every 16th float4 of it (one load of dpre feeds 4 units), then a
//      shuffle reduction;
//   2. applies the cell's gradient for its units from the stash, one thread
//      per (row, unit); the dc carry, the dh pass-through and the bias sums
//      are unit-local and stay in this block (shared memory and registers);
//      it writes its 16 columns of dx4[:, t];
//   3. (DW) stages h_prev of the tile (hs[:, t-1], read-only here) and adds
//      h_prev^T @ dpre_t into its dW columns: a thread owns rows k = tid,
//      tid+256, ... (H <= 768) and all 16 columns, sums the tile in
//      registers, and adds that to the [16, H] dW columns in shared memory.
// Then grid.sync(): dx4[:, t] complete before any block reads it. dW and db
// are written once at the end, with no atomics, so the result does not
// depend on the order in which blocks run.
//
// The launch is cooperative: H/4 blocks that must all be resident. At
// H=512 a block takes about 200 KB of shared memory with DW (the W rows,
// a 16-row dpre tile of 4H floats, the dW columns and 8 floats of carries
// per batch row), so one block per SM: 128 blocks on 132 SMs. The wrapper
// asks lstm_bwd[_nodw]_max_coresident_blocks(B, H) and raises when they do
// not fit.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int U = 4;                  // hidden units per block
constexpr int NCOL = 4 * U;           // dpre columns per block (4 gates x U)
constexpr int THREADS = 256;
constexpr int ROWS = 16;              // batch rows per tile
constexpr int KSPLIT = THREADS / ROWS;  // lanes per row in the dh product
constexpr int KPT = 3;                // dW rows k per thread: H <= 768
static_assert(KSPLIT == 16, "the shuffle reduction below sums 16 lanes");

// shared memory, in floats: W rows [U][4H+16], tile [ROWS][4H+4]
// (dpre_{t+1}, then h_prev), dh carry of the tile [ROWS*U], dpre_t of the
// tile [ROWS][NCOL], dc and dh pass-through carries [B][U] each, dW
// columns [NCOL][H] (DW only)
size_t smem_floats(int B, int H, bool dw) {
  const size_t H4 = 4 * (size_t)H;
  return U * (H4 + 16) + ROWS * (H4 + 4) + ROWS * U + ROWS * NCOL +
         2 * (size_t)B * U + (dw ? (size_t)H * NCOL : 0);
}

size_t smem_bytes(int B, int H, bool dw) {
  return sizeof(float) * smem_floats(B, H, dw);
}

// 16 bytes global -> shared without a register round trip, cached in L2
// only (.cg): the source may have been written by another block during
// this launch, so no possibly stale L1 line may serve it
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// rows [b0, b0+nrows) of a [B, T, width] array at step t into a tile of
// row pitch ld; every thread issues its copies, then waits for them
__device__ __forceinline__ void stage_rows(float* tile, int ld,
                                           const float* src, int b0,
                                           int nrows, int t, int T,
                                           int width) {
  const int w4 = width / 4;
  for (int i = threadIdx.x; i < nrows * w4; i += THREADS) {
    const int r = i / w4, k4 = i % w4;
    const size_t bt = (size_t)(b0 + r) * T + t;
    cp_async16(tile + r * ld + 4 * k4, src + bt * width + 4 * k4);
  }
  cp_async_wait_all();
}

template <bool DW>
__global__ void __launch_bounds__(THREADS)
lstm_bwd_kernel(const float* __restrict__ w, const float* __restrict__ bias,
                const float* __restrict__ mask,
                const float* __restrict__ reset,
                const float* __restrict__ gates,
                const float* __restrict__ hs, const float* __restrict__ cs,
                const float* __restrict__ g_hs,
                const float* __restrict__ g_cs, float* dx4,
                float* __restrict__ dw, float* __restrict__ db, int B, int T,
                int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int H4 = 4 * H;
  const int LDW = H4 + 16;
  const int LDP = H4 + 4;
  const int LDH = H + 4;
  float* w_s = smem;                        // w_s[uu*LDW + k] = W[u0+uu, k]
  float* tile = w_s + U * LDW;              // dpre_{t+1} or h_prev rows
  float* dhn_s = tile + ROWS * LDP;         // dh carry into step t
  float* dp_s = dhn_s + ROWS * U;           // (1-reset) dpre_t, c = g*U+uu
  float* dc_s = dp_s + ROWS * NCOL;         // dc carry [B][U]
  float* dhp_s = dc_s + B * U;              // dh pass-through [B][U]
  float* dw_s = dhp_s + B * U;              // dw_s[c*H + k] (DW only)

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;
  const int H4_4 = H4 / 4;

  for (int i = tid; i < U * H4_4; i += THREADS) {
    const int uu = i / H4_4, k4 = i % H4_4;
    reinterpret_cast<float4*>(w_s + uu * LDW)[k4] =
        reinterpret_cast<const float4*>(w + (size_t)(u0 + uu) * H4)[k4];
  }
  for (int i = tid; i < 2 * B * U; i += THREADS) dc_s[i] = 0.f;
  if (DW)
    for (int i = tid; i < H * NCOL; i += THREADS) dw_s[i] = 0.f;

  // the cell-gradient thread of (row r of a tile, unit uu): its peepholes
  // and its bias sums, accumulated over every tile and step
  const int e_r = tid / U, e_uu = tid % U, e_j = u0 + e_uu;
  const float pi = bias[4 * H + e_j], pf = bias[5 * H + e_j],
              po = bias[6 * H + e_j];
  float sb[7] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};

  // the dh product: KSPLIT adjacent lanes per tile row, each forming the
  // 4 units' partial sums over every KSPLIT-th float4 of the row
  const int d_r = tid / KSPLIT, d_split = tid % KSPLIT;
  __syncthreads();

  for (int t = T - 1; t >= 0; --t) {
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      const int nrows = min(ROWS, B - b0);
      // the cell-gradient thread's inputs, loaded before step 1 so their
      // latency hides under the staging and the dh product
      const bool e_on = tid < nrows * U;
      const size_t e_bt = (size_t)(b0 + e_r) * T + t;
      float e_m = 0.f, e_ghs = 0.f, e_gcs = 0.f, e_c = 0.f, e_cp = 0.f;
      float e_p = 1.f;
      float4 e_gate = make_float4(0.f, 0.f, 0.f, 0.f);
      if (e_on) {
        e_m = mask[e_bt];
        e_ghs = g_hs[e_bt * H + e_j];
        if (g_cs != nullptr) e_gcs = g_cs[e_bt * H + e_j];
        const float* gr = gates + e_bt * H4;
        e_gate = make_float4(gr[e_j], gr[H + e_j], gr[2 * H + e_j],
                             gr[3 * H + e_j]);
        e_c = cs[e_bt * H + e_j];
        if (reset != nullptr) e_p = 1.f - reset[e_bt];
        if (t > 0) e_cp = cs[(e_bt - 1) * H + e_j] * e_p;
      }

      // 1. dh carry into step t: dpre_{t+1} @ W[units]^T + pass-through,
      //    gated by the reset of step t+1
      if (t < T - 1) {
        stage_rows(tile, LDP, dx4, b0, nrows, t + 1, T, H4);
        __syncthreads();
        float acc[U] = {0.f, 0.f, 0.f, 0.f};
        if (d_r < nrows) {
          const float4* prow =
              reinterpret_cast<const float4*>(tile + d_r * LDP);
          for (int k4 = d_split; k4 < H4_4; k4 += KSPLIT) {
            const float4 p = prow[k4];
#pragma unroll
            for (int uu = 0; uu < U; ++uu) {
              const float4 q =
                  reinterpret_cast<const float4*>(w_s + uu * LDW)[k4];
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
        if (d_split < U && d_r < nrows) {
          const int b = b0 + d_r;
          float v = d_split == 0 ? acc[0]
                  : d_split == 1 ? acc[1]
                  : d_split == 2 ? acc[2] : acc[3];
          v += dhp_s[b * U + d_split];
          if (reset != nullptr) v *= 1.f - reset[(size_t)b * T + t + 1];
          dhn_s[d_r * U + d_split] = v;
        }
        __syncthreads();
      }

      // 2. the cell's gradient for (row, unit) from the stash
      if (e_on) {
        const int b = b0 + e_r;
        const float m = e_m;
        const float dh_t = e_ghs + (t < T - 1 ? dhn_s[e_r * U + e_uu] : 0.f);
        const float dc_t = e_gcs + dc_s[b * U + e_uu];
        const float dh_new = m * dh_t, dc_in = m * dc_t;
        const float dh_pass = (1.f - m) * dh_t, dc_pass = (1.f - m) * dc_t;
        const float ig = e_gate.x, fg = e_gate.y, gg = e_gate.z,
                    og = e_gate.w;
        const float c_new = e_c, c_prev = e_cp, p = e_p;
        const size_t bt = e_bt;
        const float tanh_c = tanhf(c_new);
        const float d_o = dh_new * tanh_c * og * (1.f - og);
        const float dc_new =
            dh_new * og * (1.f - tanh_c * tanh_c) + dc_in + d_o * po;
        const float d_i = dc_new * gg * ig * (1.f - ig);
        const float d_f = dc_new * c_prev * fg * (1.f - fg);
        const float d_g = dc_new * ig * (1.f - gg * gg);
        dc_s[b * U + e_uu] =
            (dc_new * fg + d_i * pi + d_f * pf + dc_pass) * p;
        dhp_s[b * U + e_uu] = dh_pass;
        float* out = dx4 + bt * H4;
        out[e_j] = d_i;
        out[H + e_j] = d_f;
        out[2 * H + e_j] = d_g;
        out[3 * H + e_j] = d_o;
        if (DW) {
          // h_prev_eff^T dpre = h_prev^T ((1-reset) dpre): the reset
          // rides on dpre, so h_prev is staged as the forward wrote it
          float* dp = dp_s + e_r * NCOL;
          dp[e_uu] = d_i * p;
          dp[U + e_uu] = d_f * p;
          dp[2 * U + e_uu] = d_g * p;
          dp[3 * U + e_uu] = d_o * p;
          sb[0] += d_i;
          sb[1] += d_f;
          sb[2] += d_g;
          sb[3] += d_o;
          sb[4] += d_i * c_prev;
          sb[5] += d_f * c_prev;
          sb[6] += d_o * c_new;
        }
      }
      __syncthreads();

      // 3. dW[:, own columns] += h_prev^T @ dpre_t over the tile's rows
      //    (h_prev is zero at t = 0): thread tid owns rows k = tid + 256q
      //    and all 16 columns, summed in registers over the tile
      if (DW && t > 0) {
        stage_rows(tile, LDH, hs, b0, nrows, t - 1, T, H);
        __syncthreads();
        float acc[KPT][NCOL];
#pragma unroll
        for (int q = 0; q < KPT; ++q)
#pragma unroll
          for (int c = 0; c < NCOL; ++c) acc[q][c] = 0.f;
        for (int r = 0; r < nrows; ++r) {
          float d[NCOL];
#pragma unroll
          for (int c4 = 0; c4 < NCOL / 4; ++c4) {
            const float4 v =
                reinterpret_cast<const float4*>(dp_s + r * NCOL)[c4];
            d[4 * c4] = v.x;
            d[4 * c4 + 1] = v.y;
            d[4 * c4 + 2] = v.z;
            d[4 * c4 + 3] = v.w;
          }
#pragma unroll
          for (int q = 0; q < KPT; ++q) {
            const int k = tid + q * THREADS;
            if (k < H) {
              const float h = tile[r * LDH + k];
#pragma unroll
              for (int c = 0; c < NCOL; ++c)
                acc[q][c] = fmaf(h, d[c], acc[q][c]);
            }
          }
        }
#pragma unroll
        for (int q = 0; q < KPT; ++q) {
          const int k = tid + q * THREADS;
          if (k < H)
#pragma unroll
            for (int c = 0; c < NCOL; ++c) dw_s[c * H + k] += acc[q][c];
        }
      }
      if (DW) __syncthreads();  // tile and dp_s are refilled next tile
    }
    grid.sync();          // dx4[:, t] complete before any block reads it
  }

  if (DW) {
    auto gcol = [&](int c) { return (c / U) * H + u0 + c % U; };
    for (int i = tid; i < H * NCOL; i += THREADS) {
      const int c = i / H, k = i % H;
      dw[(size_t)k * H4 + gcol(c)] = dw_s[i];
    }
    // bias sums: thread (r, uu) holds its rows' share; add up the ROWS
    // shares of each unit
    float* red = tile;    // [ROWS*U][7]
    if (tid < ROWS * U)
      for (int q = 0; q < 7; ++q) red[tid * 7 + q] = sb[q];
    __syncthreads();
    if (tid < U * 7) {
      const int uu = tid / 7, q = tid % 7;
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s += red[(r * U + uu) * 7 + q];
      // [gate biases i, f, g, o | pi | pf | po], each H long
      db[q * H + u0 + uu] = s;
    }
  }
}

template <bool DW>
cudaError_t prepare(int B, int H) {
  return cudaFuncSetAttribute(lstm_bwd_kernel<DW>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(B, H, DW));
}

template <bool DW>
int max_coresident_blocks(int B, int H) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -(int)err;
  int smem_max = 0;
  err = cudaDeviceGetAttribute(&smem_max,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return -(int)err;
  if (smem_bytes(B, H, DW) > (size_t)smem_max) return 0;
  if (DW && H > THREADS * KPT) return 0;  // dW rows a thread holds
  err = prepare<DW>(B, H);
  if (err != cudaSuccess) return -(int)err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, lstm_bwd_kernel<DW>, THREADS, smem_bytes(B, H, DW));
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

template <bool DW>
int launch(const float* w, const float* bias, const float* mask,
           const float* reset, const float* gates, const float* hs,
           const float* cs, const float* g_hs, const float* g_cs, float* dx4,
           float* dw, float* db, int B, int T, int H, void* stream) {
  cudaError_t err = prepare<DW>(B, H);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&w,    (void*)&bias, (void*)&mask, (void*)&reset,
                  (void*)&gates, (void*)&hs,  (void*)&cs,   (void*)&g_hs,
                  (void*)&g_cs, (void*)&dx4,  (void*)&dw,   (void*)&db,
                  (void*)&B,    (void*)&T,    (void*)&H};
  err = cudaLaunchCooperativeKernel((const void*)lstm_bwd_kernel<DW>,
                                    dim3(H / U), dim3(THREADS), args,
                                    smem_bytes(B, H, DW),
                                    (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Blocks of each kernel that can be resident at once on the current device
// for batch B and hidden size H (0 when a block's shared memory does not
// fit); a negative value is minus a cudaError_t. A launch needs H/U.
int lstm_bwd_max_coresident_blocks(int B, int H) {
  return max_coresident_blocks<true>(B, H);
}

int lstm_bwd_nodw_max_coresident_blocks(int B, int H) {
  return max_coresident_blocks<false>(B, H);
}

// Launch on `stream` of the current device; return the cudaError_t of the
// launch (0 on success). `reset` and `g_cs` may be NULL. lstm_bwd_nodw
// reads neither `hs` nor writes `dw` and `db`: they may be NULL there.
int lstm_bwd(const float* w, const float* bias, const float* mask,
             const float* reset, const float* gates, const float* hs,
             const float* cs, const float* g_hs, const float* g_cs,
             float* dx4, float* dw, float* db, int B, int T, int H,
             void* stream) {
  return launch<true>(w, bias, mask, reset, gates, hs, cs, g_hs, g_cs, dx4,
                      dw, db, B, T, H, stream);
}

int lstm_bwd_nodw(const float* w, const float* bias, const float* mask,
                  const float* reset, const float* gates, const float* hs,
                  const float* cs, const float* g_hs, const float* g_cs,
                  float* dx4, float* dw, float* db, int B, int T, int H,
                  void* stream) {
  return launch<false>(w, bias, mask, reset, gates, hs, cs, g_hs, g_cs, dx4,
                       dw, db, B, T, H, stream);
}

const char* lstm_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

const char* lstm_bwd_nodw_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
