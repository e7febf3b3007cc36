// Fused LSTM forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/lstm.py `_fwd_kernel` (launched by
// `_fwd_call`), the Pallas TPU kernel behind `fused_lstm`'s forward. It
// computes the same thing: the masked LSTM recurrence over a padded batch,
// gate order [i, f, c, o], peepholes at bias[4H:7H] (i and f on c_prev, o
// on c_new), the mask-gated carry (h_t = m*h_new + (1-m)*h_{t-1}, the same
// for c) and the optional segment-start reset that zeroes the carry
// entering a step. It writes hs and cs and, when training asks for it (a
// non-NULL `gates`), the stash of post-activation gates [i, f, g, o] that
// the backward (lstm_bwd.cu) reads. The stash is written at every step,
// padded ones too: the backward multiplies by the mask rather than
// selecting, and 0 * garbage may be NaN.
//
// Layout: batch-major x4 [B, T, 4H], mask and reset [B, T], W [H, 4H],
// bias [7H], hs and cs [B, T, H], gates [B, T, 4H]; all float32 (but see
// the bf16 form below), all contiguous.
//
// lstm_fwd_kernel also has a bf16 form (lstm_fwd_bf16), the TPU kernel's
// arithmetic on bf16 operands: x4, W, bias, hs, cs and the stash bf16,
// mask and reset float32. The block's h and c carries stay float32 in
// shared memory (the TPU kernel's h_scr and c_scr), and the h_{t-1} rows
// it stages from hs[:, t-1] are bf16: the carry rounded to nearest even,
// exactly the product operand jnp's astype gives, at half the staged
// bytes. W is widened to float32 as a block loads it (exactly: 128 KiB at
// U = 16, H = 512, as the float32 form's), each product of two bf16
// values is exact in float32 and the sums are float32, as
// preferred_element_type=float32; the bias is widened, the gates, the
// peepholes on the float32 c and the mask blend are float32, and hs, cs
// and the stash are rounded on store. H must be a multiple of 8 (16-byte
// runs of bf16). kernels/lstm.py lstm_fwd_plan gives the bf16 form the
// same rule with its own shared memory (the classifier's (64, 512) takes
// U = 16, R = 16 there too, 183 KiB a block); the all-rows kernel has no
// bf16 form. Its bound is not the float32 form's: bf16 operands summed in
// float32 are the bf16 tensor cores' arithmetic, so at 989 TFLOP/s the
// products below take about 0.014 ms, and the bf16 bytes (x4, W, hs, cs
// and the stash, about 68 MB at that shape) 0.020 ms: bytes bound it. It
// runs its products on the CUDA cores all the same, and each lane widens
// the bf16 h operands it loads (one integer operation a value, some 12%
// more instructions than the float32 form's FMAs), so it trails the
// float32 form by about 8% at that shape (PERF.md, PR 27).
//
// Bound on an H100 SXM: the recurrent product h_{t-1} @ W costs
// 2*B*T*H*4H flops (13.4 GFLOP at B=64, T=100, H=512 with every step
// valid), done in float32 on the CUDA cores (67 TFLOP/s): about 0.2 ms
// (chip_smoke.py counts the valid steps only: 0.125 ms on its ragged
// rows). The bytes it must move (x4 read once, hs and cs written once, W
// once: about 83 MB at that shape) take about 0.025 ms at 3.35 TB/s. So
// operations bound it, and the time loop is serial: each step needs all of
// h_{t-1} before any of h_t.
//
// Design of lstm_fwd_kernel<U>. The TPU kernel keeps all of W in VMEM; at
// H=512 W is 4 MiB and an SM has 227 KB of shared memory, so W is split
// across SMs. A block owns U hidden units (16 where they divide H, else 8
// or 4) and R batch rows: grid (H / U, ceil(B / R)), one cooperative
// launch whose blocks are all resident, one an SM (kernels/lstm.py
// lstm_fwd_plan picks U and R from the shape: the classifier's (64, 512)
// takes U = 16, R = 16, 32 unit groups x 4 row groups). It keeps its
// units' 4U columns of W in shared memory for the whole launch (k
// contiguous per column: 128 KiB at U = 16, H = 512), and the cell and
// hidden carries of its (row, unit) pairs, which no other block reads: no
// read-back of cs. Each step it stages only its own rows of h_{t-1}
// (written by the H / U blocks of its row group into hs[:, t-1]): B*H*4
// bytes times H / U a step across the grid, 4 MiB at the classifier's
// shape where a block of 4 units that staged every row took 16. The rows
// come in tiles of RT = 256 / U (one (row, unit) pair a thread in the
// cell); warp w owns the w-th eighth of k and stages that slice of a tile
// itself, by cp.async.cg (L2 only: hs was written by other blocks during
// the launch, so no possibly stale L1 line may serve it), in two halves,
// so its product on the first half starts while the second is in flight;
// the warp waits for its own copies only (no block barrier), and stages
// the next tile's slice as soon as its product has read this one. The
// product stays float32 FMA, as the backward's recurrence (a TF32 product
// would compound its rounding over T steps). A lane takes 32 outputs of
// the tile (4 rows x 8 columns): per float4 of k, 12 loads of 16 bytes
// feed 128 FMAs, and it loads the next float4's operands during the
// current one's FMAs (two register sets). A warp's loads of a float4 are
// 64 / U distinct h rows and U / 2 distinct W columns, each broadcast to
// the lanes that share it; rows and columns are padded to an odd number
// of float4s, so they fall in distinct banks. The warps' partial sums meet
// in shared memory, and the thread that owns a (row, unit) pair adds its 4
// gates' sums in warp order: no atomics, two launches give the same bits.
// x4, mask and reset of the next tile (of step t+1 after the last) are
// loaded during this one: they do not depend on h. The stash is written in
// runs of U units. grid.sync() closes each step: hs[:, t] complete before
// any block stages it (a row group's H / U = 32 blocks at H = 512 exceed a
// cluster's 16).
//
// lstm_fwd_all_rows_kernel is the first port's kernel, kept for the shapes
// whose (U, R) blocks do not fit an H100 at once (B past some 2000 at H =
// 512, or H / 4 > 132 unit groups with H not a multiple of 8): H / 4
// blocks of 4 units, each staging every batch row of h_{t-1} a step in
// 32-row tiles and reading its cell carry back from cs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "hopper.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

// --- lstm_fwd_kernel<U>: U units and R rows a block --------------------------

// the pitch of a staged row of h and of a W column, in float4s: odd, so
// that 8 consecutive rows (columns) fall in distinct banks
__host__ __device__ __forceinline__ int pitch4(int H) { return (H / 4) | 1; }

// the layout of a block of U units: tiles of RT rows (a (row, unit) pair a
// thread in the cell); a lane's 32 outputs of a tile are rows rg + LR*a
// (a < 4) and columns cl + LC*e (e < 8) of the block's 4U, gate-major
// (column g*U + u is gate g of unit u0 + u)
template <int U>
struct Layout {
  static constexpr int NC = 4 * U;
  static constexpr int RT = THREADS / U;
  static constexpr int LC = U / 2;
  static constexpr int LR = 32 / LC;
  static constexpr int RL = RT / LR;
  static constexpr int CL = NC / LC;
  static constexpr int PP = NC + LC;  // a partial row's pitch: no conflicts
  static_assert(RL * CL == 32, "32 outputs a lane");
};

// the pitch of a staged row of h of storage type S, in elements: 4 *
// pitch4 for float (W's pitch), an odd number of 16-byte runs for bf16
template <typename S>
__host__ __device__ __forceinline__ int tile_pitch(int H) {
  return std::is_same<S, float>::value ? 4 * pitch4(H) : 8 * ((H / 8) | 1);
}

// shared memory: W's columns [4U][4*pitch4] as float, the warps' partial
// sums [WARPS][RT][PP], the cell and hidden carries [R][U] each (floats),
// and a tile of h_{t-1} [RT][tile_pitch] of S
template <typename S>
size_t smem_bytes(int H, int U, int R) {
  const int LD = 4 * pitch4(H), RT = THREADS / U;
  return sizeof(float) * ((size_t)4 * U * LD +
                          (size_t)WARPS * RT * (4 * U + U / 2) +
                          2 * (size_t)R * U) +
         sizeof(S) * (size_t)RT * tile_pitch<S>(H);
}

// a (row, unit) pair's inputs at a step other than h_{t-1}, as loaded
struct StepIn {
  float x[4], m, rs;
};

template <typename S>
__device__ __forceinline__ StepIn step_inputs(const S* __restrict__ x4,
                                              const float* __restrict__ mask,
                                              const float* __restrict__ reset,
                                              int b, int j, int t, int T,
                                              int H, bool live) {
  StepIn s = {{0.f, 0.f, 0.f, 0.f}, 0.f, 0.f};
  if (!live) return s;
  const size_t bt = (size_t)b * T + t;
  const S* xr = x4 + bt * 4 * (size_t)H;
#pragma unroll
  for (int g = 0; g < 4; ++g) s.x[g] = ld(xr + g * H + j);
  s.m = mask[bt];
  if (reset != nullptr) s.rs = reset[bt];
  return s;
}

// a lane's operands of float4 k4: its rows of the staged tile (pitch ldt
// elements of S) as float4 and its columns of W (pitch ld float4s)
template <int U, typename S>
__device__ __forceinline__ void load_k4(float4 (&p)[Layout<U>::RL],
                                        float4 (&v)[Layout<U>::CL],
                                        const S* hst, int ldt,
                                        const float4* wst, int ld, int rg,
                                        int cl, int k4) {
  using L = Layout<U>;
#pragma unroll
  for (int a = 0; a < L::RL; ++a)
    p[a] = load4(hst + (size_t)(rg + L::LR * a) * ldt + 4 * k4);
#pragma unroll
  for (int e = 0; e < L::CL; ++e) v[e] = wst[(cl + L::LC * e) * ld + k4];
}

// acc[a][e] += p[a] . v[e], the 4 products of a float4 in order
template <int U>
__device__ __forceinline__ void fma_k4(float (&acc)[32],
                                       const float4 (&p)[Layout<U>::RL],
                                       const float4 (&v)[Layout<U>::CL]) {
  using L = Layout<U>;
#pragma unroll
  for (int a = 0; a < L::RL; ++a)
#pragma unroll
    for (int e = 0; e < L::CL; ++e) {
      float s = acc[a * L::CL + e];
      s = fmaf(p[a].x, v[e].x, s);
      s = fmaf(p[a].y, v[e].y, s);
      s = fmaf(p[a].z, v[e].z, s);
      s = fmaf(p[a].w, v[e].w, s);
      acc[a * L::CL + e] = s;
    }
}

// the lane's sums over float4s [k_beg, k_end) of the staged tile: the
// loads of float4 i + 1 in flight during float4 i's FMAs
template <int U, typename S>
__device__ __forceinline__ void product(float (&acc)[32], const S* hst,
                                        int ldt, const float4* wst, int ld,
                                        int rg, int cl, int k_beg,
                                        int k_end) {
  using L = Layout<U>;
  const int n = k_end - k_beg;
  if (n <= 0) return;
  float4 p0[L::RL], v0[L::CL], p1[L::RL], v1[L::CL];
  load_k4<U>(p0, v0, hst, ldt, wst, ld, rg, cl, k_beg);
  int i = 0;
  for (; i + 1 < n; i += 2) {
    load_k4<U>(p1, v1, hst, ldt, wst, ld, rg, cl, k_beg + i + 1);
    fma_k4<U>(acc, p0, v0);
    if (i + 2 < n)
      load_k4<U>(p0, v0, hst, ldt, wst, ld, rg, cl, k_beg + i + 2);
    fma_k4<U>(acc, p1, v1);
  }
  if (i < n) fma_k4<U>(acc, p0, v0);
}

// grid (H / U, ceil(B / R)): block (x, y) owns units [xU, xU + U) and rows
// [yR, yR + R), R a multiple of RT. See the note at the top of the file.
// S = float: everything float32. S = bf16: x4, W, bias, hs, cs and the
// stash bf16, the carries and the arithmetic float32 (the note's bf16
// form). mask and reset are float32 in both.
template <int U, typename S>
__global__ void __launch_bounds__(THREADS, 1)
lstm_fwd_kernel(const S* __restrict__ x4, const S* __restrict__ w,
                const S* __restrict__ bias, const float* __restrict__ mask,
                const float* __restrict__ reset, S* hs, S* cs,
                S* __restrict__ gates, int B, int T, int H, int R) {
  using L = Layout<U>;
  constexpr int NC = L::NC, RT = L::RT, LC = L::LC, LR = L::LR, RL = L::RL,
                CL = L::CL, PP = L::PP;
  constexpr int V = VEC<S>;  // elements of S a 16-byte copy moves
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float smem[];
  const int LD4 = pitch4(H), LD = 4 * LD4, LDT = tile_pitch<S>(H);
  float* w_s = smem;                   // [NC][LD]: W[k, gate col of c]
  float* part = w_s + NC * LD;         // [WARPS][RT][PP]: the warps' sums
  float* c_s = part + WARPS * RT * PP;  // [R][U]: the cell carry
  float* hc_s = c_s + R * U;           // [R][U]: the hidden carry
  S* h_s = reinterpret_cast<S*>(hc_s + R * U);  // [RT][LDT]: a tile's h_{t-1}

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u0 = blockIdx.x * U, b0 = blockIdx.y * R;
  const int tiles = R / RT;
  const size_t H4 = 4 * (size_t)H;
  // the warp's eighth of k in 16-byte runs of S, staged and multiplied in
  // two halves; the product walks them as float4s (V / 4 a run)
  const int nv = H / V;
  const int kb = nv * warp / WARPS, ke = nv * (warp + 1) / WARPS;
  const int km = (kb + ke) / 2;
  constexpr int F4 = V / 4;

  // W's columns stay in shared memory for the whole recurrence
  for (int i = tid; i < H * NC; i += THREADS) {
    const int k = i / NC, c = i % NC;
    w_s[c * LD + k] = ld(w + (size_t)k * H4 + (c / U) * H + u0 + c % U);
  }
  for (int i = tid; i < 2 * R * U; i += THREADS) c_s[i] = 0.f;

  // the thread's (row, unit) pair of each tile, its biases and peepholes
  const int o_r = tid / U, o_u = tid % U, o_j = u0 + o_u;
  float b_g[4];
#pragma unroll
  for (int g = 0; g < 4; ++g) b_g[g] = ld(bias + g * H + o_j);
  const float pi = ld(bias + 4 * H + o_j), pf = ld(bias + 5 * H + o_j),
              po = ld(bias + 6 * H + o_j);
  // the lane's place in a tile's outputs
  const int rg = lane / LC, cl = lane % LC;

  // the warp's k-slice [k_lo, k_hi) (in runs of V) of tile i's rows of
  // h_{t-1} (step t's input) into h_s; rows past B read as zeros
  auto stage = [&](int i, int t, int k_lo, int k_hi) {
    const int nk = k_hi - k_lo, tb = b0 + i * RT;
    for (int e = lane; e < RT * nk; e += 32) {
      const int r = e / nk, kv = k_lo + e % nk;
      const bool ok = tb + r < B;
      cp_async16(reinterpret_cast<float*>(h_s + r * LDT + V * kv),
                 reinterpret_cast<const float*>(
                     ok ? hs + ((size_t)(tb + r) * T + t - 1) * H + V * kv
                        : hs),
                 ok);
    }
  };
  auto stage_tile = [&](int i, int t) {
    stage(i, t, kb, km);
    cp_async_commit();
    stage(i, t, km, ke);
    cp_async_commit();
  };

  StepIn nx = step_inputs<S>(x4, mask, reset, b0 + o_r, o_j, 0, T, H,
                             b0 + o_r < B);
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    if (t > 0) stage_tile(0, t);
    for (int i = 0; i < tiles; ++i) {
      const StepIn x = nx;
      {  // the next tile's inputs (step t+1's after the last), in flight
        const int ni = i + 1 < tiles ? i + 1 : 0;
        const int nt = i + 1 < tiles ? t : t + 1;
        const int nb = b0 + ni * RT + o_r;
        if (nt < T)
          nx = step_inputs<S>(x4, mask, reset, nb, o_j, nt, T, H, nb < B);
      }
      const int r = i * RT + o_r;       // the pair's row in the block
      const int pr = r * U + o_u;       // its carries

      // h_{t-1} @ W for the pair's 4 gate columns (zero at t = 0)
      float s[4] = {0.f, 0.f, 0.f, 0.f};
      if (t > 0) {
        float acc[32];
#pragma unroll
        for (int a = 0; a < 32; ++a) acc[a] = 0.f;
        const float4* wst = reinterpret_cast<const float4*>(w_s);
        cp_async_wait<1>();  // the first half of the slice has landed
        __syncwarp();        // ... the whole warp's copies of it
        product<U>(acc, h_s, LDT, wst, LD4, rg, cl, F4 * kb, F4 * km);
        cp_async_wait<0>();
        __syncwarp();
        product<U>(acc, h_s, LDT, wst, LD4, rg, cl, F4 * km, F4 * ke);
        __syncwarp();        // the warp's reads of its slice are done
        if (i + 1 < tiles) stage_tile(i + 1, t);
        if (i > 0) __syncthreads();  // the last tile's sums have been read
        float* pw = part + warp * RT * PP;
#pragma unroll
        for (int a = 0; a < RL; ++a)
#pragma unroll
          for (int e = 0; e < CL; ++e)
            pw[(rg + LR * a) * PP + cl + LC * e] = acc[a * CL + e];
        __syncthreads();
#pragma unroll
        for (int q = 0; q < WARPS; ++q) {
          const float* pq = part + q * RT * PP + o_r * PP + o_u;
#pragma unroll
          for (int g = 0; g < 4; ++g) s[g] += pq[g * U];
        }
      }

      // the gate math and the mask-gated carry of the pair
      const int b = b0 + r;
      if (b < B) {
        const float p = 1.f - x.rs;  // the reset gates the carry entering
        const float c_prev = c_s[pr] * p, h_prev = hc_s[pr] * p;
        const float pre_i = (x.x[0] + s[0] * p) + b_g[0];
        const float pre_f = (x.x[1] + s[1] * p) + b_g[1];
        const float pre_g = (x.x[2] + s[2] * p) + b_g[2];
        const float pre_o = (x.x[3] + s[3] * p) + b_g[3];
        const float ig = sigm(pre_i + pi * c_prev);
        const float fg = sigm(pre_f + pf * c_prev);
        const float gg = tanhf(pre_g);
        const float c_new = fg * c_prev + ig * gg;
        const float og = sigm(pre_o + po * c_new);
        const float h_new = og * tanhf(c_new);
        const float h_t = x.m * h_new + (1.f - x.m) * h_prev;
        const float c_t = x.m * c_new + (1.f - x.m) * c_prev;
        c_s[pr] = c_t;
        hc_s[pr] = h_t;
        const size_t bt = (size_t)b * T + t;
        if (gates != nullptr) {
          S* gr = gates + bt * H4;
          st(gr + o_j, ig);
          st(gr + H + o_j, fg);
          st(gr + 2 * H + o_j, gg);
          st(gr + 3 * H + o_j, og);
        }
        st(hs + bt * H + o_j, h_t);
        st(cs + bt * H + o_j, c_t);
      }
    }
    if (t + 1 < T) grid.sync();  // hs[:, t] complete before any block
  }                              // stages it
}

template <int U, typename S>
cudaError_t launch(const S* x4, const S* w, const S* bias, const float* mask,
                   const float* reset, S* hs, S* cs, S* gates, int B, int T,
                   int H, int R, cudaStream_t stream) {
  const size_t smem = smem_bytes<S>(H, U, R);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_kernel<U, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&x4,   (void*)&w,  (void*)&bias, (void*)&mask,
                  (void*)&reset, (void*)&hs, (void*)&cs,   (void*)&gates,
                  (void*)&B,     (void*)&T,  (void*)&H,    (void*)&R};
  err = cudaLaunchCooperativeKernel((const void*)lstm_fwd_kernel<U, S>,
                                    dim3(H / U, (B + R - 1) / R),
                                    dim3(THREADS), args, smem, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// lstm_fwd_kernel<U, S>'s launch for U of 4, 8 or 16
template <typename S>
int launch_units(const S* x4, const S* w, const S* bias, const float* mask,
                 const float* reset, S* hs, S* cs, S* gates, int B, int T,
                 int H, int U, int R, cudaStream_t st) {
  if (R % (THREADS / U) != 0 || (B + R - 1) / R > 65535)
    return (int)cudaErrorInvalidValue;
  switch (U) {
    case 4:
      return (int)launch<4, S>(x4, w, bias, mask, reset, hs, cs, gates, B, T,
                               H, R, st);
    case 8:
      return (int)launch<8, S>(x4, w, bias, mask, reset, hs, cs, gates, B, T,
                               H, R, st);
    default:
      return (int)launch<16, S>(x4, w, bias, mask, reset, hs, cs, gates, B,
                                T, H, R, st);
  }
}

// --- lstm_fwd_all_rows_kernel: 4 units a block, every row --------------------

constexpr int AR_U = 4;                    // hidden units per block
constexpr int AR_NCOL = 4 * AR_U;          // W columns per block
constexpr int AR_RG = THREADS / AR_NCOL;   // row groups: threads per column
constexpr int AR_RPT = 2;                  // batch rows per thread
constexpr int AR_ROWS = AR_RG * AR_RPT;    // batch rows per tile

// shared memory: W columns [NCOL][H+4] (transposed, so a thread reads its
// column as float4 runs along k; the +4 pad spreads the columns over the
// banks), h_{t-1} tile [ROWS][H+4], pre-activations [ROWS][NCOL]
size_t all_rows_smem_bytes(int H) {
  return sizeof(float) * ((size_t)(AR_NCOL + AR_ROWS) * (H + 4) +
                          (size_t)AR_ROWS * AR_NCOL);
}

// grid H / 4: block j owns hidden units [4j, 4j+4) and keeps those units'
// 16 columns of W in shared memory; each step it stages every row of
// h_{t-1} in 32-row tiles, forms its 16 columns of the pre-activation for
// each row, applies the gate math for its units (reading its own cell
// carry back from cs) and writes its slice of hs[:, t] and cs[:, t]
__global__ void __launch_bounds__(THREADS)
lstm_fwd_all_rows_kernel(const float* __restrict__ x4,
                         const float* __restrict__ w,
                         const float* __restrict__ bias,
                         const float* __restrict__ mask,
                         const float* __restrict__ reset, float* hs,
                         float* cs, float* __restrict__ gates, int B, int T,
                         int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int LD = H + 4;
  float* w_s = smem;                  // w_s[c*LD + k] = W[k, gcol(c)]
  float* h_s = w_s + AR_NCOL * LD;    // h_s[r*LD + k] = h_{t-1}[b0+r, k]
  float* pre_s = h_s + AR_ROWS * LD;  // pre_s[r*NCOL + c]

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * AR_U;   // first hidden unit of this block
  const int col = tid % AR_NCOL;      // gate col / U, unit col % U
  const int rg = tid / AR_NCOL;
  const size_t H4 = 4 * (size_t)H;
  const int H_4 = H / 4;
  // column of x4 / W / bias that local column c stands for
  auto gcol = [&](int c) { return (c / AR_U) * H + u0 + c % AR_U; };

  for (int i = tid; i < AR_NCOL * H; i += THREADS) {
    const int k = i / AR_NCOL, c = i % AR_NCOL;
    w_s[c * LD + k] = w[(size_t)k * H4 + gcol(c)];
  }
  const float b_col = bias[gcol(col)];
  __syncthreads();

  const float4* w_col = reinterpret_cast<const float4*>(w_s + col * LD);
  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += AR_ROWS) {
      const int nrows = min(AR_ROWS, B - b0);
      // stage h_{t-1}, reset-gated; hs is written by other blocks during
      // this launch, so read it through L2 (__ldcg), never a stale L1 line
      for (int i = tid; i < nrows * H_4; i += THREADS) {
        const int r = i / H_4, k4 = i % H_4;
        const size_t bt = (size_t)(b0 + r) * T + t;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (t > 0) {
          v = __ldcg(reinterpret_cast<const float4*>(hs + (bt - 1) * H) + k4);
          if (reset != nullptr) {
            const float p = 1.f - reset[bt];
            v.x *= p; v.y *= p; v.z *= p; v.w *= p;
          }
        }
        reinterpret_cast<float4*>(h_s + r * LD)[k4] = v;
      }
      __syncthreads();

      // pre = x4 + h_{t-1} @ W + b for this block's columns
      float acc[AR_RPT];
#pragma unroll
      for (int j = 0; j < AR_RPT; ++j) acc[j] = 0.f;
      for (int k4 = 0; k4 < H_4; ++k4) {
        const float4 wv = w_col[k4];
#pragma unroll
        for (int j = 0; j < AR_RPT; ++j) {
          const float4 hv = reinterpret_cast<const float4*>(
              h_s + (rg + j * AR_RG) * LD)[k4];
          acc[j] = fmaf(hv.x, wv.x, acc[j]);
          acc[j] = fmaf(hv.y, wv.y, acc[j]);
          acc[j] = fmaf(hv.z, wv.z, acc[j]);
          acc[j] = fmaf(hv.w, wv.w, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < AR_RPT; ++j) {
        const int r = rg + j * AR_RG;
        if (r < nrows) {
          const size_t bt = (size_t)(b0 + r) * T + t;
          pre_s[r * AR_NCOL + col] =
              (x4[bt * H4 + gcol(col)] + acc[j]) + b_col;
        }
      }
      __syncthreads();

      // gate math and the mask-gated carry: one thread per (row, unit)
      if (tid < nrows * AR_U) {
        const int r = tid / AR_U, uu = tid % AR_U, j = u0 + uu;
        const size_t bt = (size_t)(b0 + r) * T + t;
        const float m = mask[bt];
        const float h_prev = h_s[r * LD + j];
        float c_prev = 0.f;
        if (t > 0) {
          c_prev = __ldcg(cs + (bt - 1) * H + j);
          if (reset != nullptr) c_prev *= 1.f - reset[bt];
        }
        const float* pr = pre_s + r * AR_NCOL;
        const float ig = sigm(pr[uu] + bias[4 * H + j] * c_prev);
        const float fg = sigm(pr[AR_U + uu] + bias[5 * H + j] * c_prev);
        const float gg = tanhf(pr[2 * AR_U + uu]);
        const float c_new = fg * c_prev + ig * gg;
        const float og = sigm(pr[3 * AR_U + uu] + bias[6 * H + j] * c_new);
        const float h_new = og * tanhf(c_new);
        if (gates != nullptr) {
          float* gr = gates + bt * H4;
          gr[j] = ig;
          gr[H + j] = fg;
          gr[2 * H + j] = gg;
          gr[3 * H + j] = og;
        }
        hs[bt * H + j] = m * h_new + (1.f - m) * h_prev;
        cs[bt * H + j] = m * c_new + (1.f - m) * c_prev;
      }
      __syncthreads();  // h_s and pre_s are refilled by the next tile
    }
    grid.sync();        // hs[:, t] complete before any block reads it
  }
}

cudaError_t launch_all_rows(const float* x4, const float* w,
                            const float* bias, const float* mask,
                            const float* reset, float* hs, float* cs,
                            float* gates, int B, int T, int H,
                            cudaStream_t stream) {
  const size_t smem = all_rows_smem_bytes(H);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_fwd_all_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  void* args[] = {(void*)&x4,   (void*)&w,  (void*)&bias, (void*)&mask,
                  (void*)&reset, (void*)&hs, (void*)&cs,   (void*)&gates,
                  (void*)&B,     (void*)&T,  (void*)&H};
  err = cudaLaunchCooperativeKernel((const void*)lstm_fwd_all_rows_kernel,
                                    dim3(H / AR_U), dim3(THREADS), args, smem,
                                    stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The recurrence on `stream` of the current device: with R > 0,
// lstm_fwd_kernel<U> (U of 4, 8 or 16 dividing H, R a multiple of 256 / U;
// grid (H / U, ceil(B / R))); with R = 0 and U = 4,
// lstm_fwd_all_rows_kernel (grid H / 4). Every block must be resident at
// once (a cooperative launch, refused where they are not). Returns the
// cudaError_t of the launch (0 on success). `reset` and `gates` may be
// NULL (no reset; no stash, as serving runs it).
int lstm_fwd(const float* x4, const float* w, const float* bias,
             const float* mask, const float* reset, float* hs, float* cs,
             float* gates, int B, int T, int H, int U, int R, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B < 1 || T < 1 || H < 4 || H % 4 != 0 || R < 0 ||
      (U != 4 && U != 8 && U != 16) || H % U != 0)
    return (int)cudaErrorInvalidValue;
  if (R == 0) {
    if (U != AR_U) return (int)cudaErrorInvalidValue;
    return (int)launch_all_rows(x4, w, bias, mask, reset, hs, cs, gates, B,
                                T, H, st);
  }
  return launch_units<float>(x4, w, bias, mask, reset, hs, cs, gates, B, T,
                             H, U, R, st);
}

const char* lstm_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// The bf16 form: x4, w, bias, hs, cs and gates bf16, mask and reset
// float32; H a multiple of 8 and R > 0 (the all-rows kernel has no bf16
// form). As lstm_fwd otherwise.
int lstm_fwd_bf16(const bf16* x4, const bf16* w, const bf16* bias,
                  const float* mask, const float* reset, bf16* hs, bf16* cs,
                  bf16* gates, int B, int T, int H, int U, int R,
                  void* stream) {
  if (B < 1 || T < 1 || H < 8 || H % 8 != 0 || R < 1 ||
      (U != 4 && U != 8 && U != 16) || H % U != 0)
    return (int)cudaErrorInvalidValue;
  return launch_units<bf16>(x4, w, bias, mask, reset, hs, cs, gates, B, T, H,
                            U, R, (cudaStream_t)stream);
}

const char* lstm_fwd_bf16_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
