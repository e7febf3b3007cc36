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
// contiguous. The wrapper also hands over a scratch [2, B, H] (r*h_{t-1}
// and z).
//
// Bound on an H100 SXM: the two recurrent products cost 2*B*T*H*3H flops
// (10.07 GFLOP at B=64, T=100, H=512, every step valid), done in float32
// on the CUDA cores (67 TFLOP/s): about 0.150 ms. The bytes it must move
// (x3 read once, hs written once, Wg and Wc once: about 56 MB at that
// shape) take about 0.017 ms at 3.35 TB/s. So operations bound it, and the
// time loop is serial: each step needs all of h_{t-1} before any of h_t.
// PERF.md holds this kernel's measured times beside that bound
// (chip_smoke.py).
//
// Design. As in lstm_fwd.cu, the weights do not fit one SM (3 MiB in
// float32 at H=512 against 227 KB of shared memory), so they are split
// across blocks: block j owns hidden units [4j, 4j+4) and keeps their
// columns for the whole launch in shared memory, 2*4 columns of Wg (z and
// r) and 4 of Wc, 3*4*H floats (24 KB at H=512). Unlike the LSTM, a step
// cannot be one pass: the candidate needs (r*h_{t-1}) for ALL H units,
// and each block forms r only for its own units. So every step is two
// phases, each closed by a grid barrier:
//   (A) stage h_{t-1} (reset-gated), form z and r for the block's units,
//       and write its slice of r*h_{t-1} and of z to the scratch;
//   grid.sync()
//   (B) stage the whole r*h_{t-1}, form c for the block's units, then
//       h_t from z, c and h_{t-1}, and write its slice of hs[:, t];
//   grid.sync()
// Both syncs sit in ONE persistent cooperative launch
// (cudaLaunchCooperativeKernel), not two launches per step: the weights
// are read from device memory once per call, and a phase costs a barrier
// (about a microsecond) rather than a launch. The price against the LSTM
// is two barriers a step instead of one, and that every block must be
// resident at once: H/4 blocks, checked against the occupancy API before
// each launch (gru_fwd_max_coresident_blocks); the Python wrapper raises
// when they are not. Data that other blocks wrote during the launch (hs,
// the scratch) is read through L2 (__ldcg), never a possibly stale L1
// line.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int U = 4;                  // hidden units per block
constexpr int NA = 2 * U;             // phase A columns: z and r of U units
constexpr int NB = U;                 // phase B columns: c of U units
constexpr int THREADS = 256;
constexpr int ROWS = THREADS / NA;    // batch rows per tile (32)
constexpr int KS = THREADS / (NB * ROWS);  // phase B splits k in KS parts

// shared memory: Wg columns [NA][H+4] and Wc columns [NB][H+4] (transposed,
// so a thread reads its column as float4 runs along k; the +4 pad spreads
// the columns over the banks), one row tile [ROWS][H+4] (h_{t-1} in phase
// A, r*h_{t-1} in phase B), and the products [ROWS][NA] (phase A) or
// [KS][ROWS][NB] (phase B), both ROWS*NA floats
size_t smem_bytes(int H) {
  return sizeof(float) *
         ((size_t)(NA + NB + ROWS) * (H + 4) + (size_t)ROWS * NA);
}

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(THREADS)
gru_fwd_kernel(const float* __restrict__ x3, const float* __restrict__ wg,
               const float* __restrict__ wc, const float* __restrict__ bias,
               const float* __restrict__ mask,
               const float* __restrict__ reset, float* hs,
               float* __restrict__ gates, float* rh, float* zbuf, int B,
               int T, int H) {
  static_assert(NA * ROWS == THREADS && KS * NB * ROWS == THREADS,
                "thread layout");
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int LD = H + 4;
  float* wg_s = smem;                 // wg_s[c*LD + k] = Wg[k, gate col c]
  float* wc_s = wg_s + NA * LD;       // wc_s[c*LD + k] = Wc[k, u0 + c]
  float* tile = wc_s + NB * LD;       // tile[r*LD + k]
  float* prod = tile + ROWS * LD;     // products of the current phase

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;      // first hidden unit of this block
  const size_t H3 = 3 * (size_t)H;
  const int H_4 = H / 4;
  // column of x3 / Wg / bias that phase A's local column c stands for:
  // c / U is the gate (0 = z, 1 = r), c % U the unit
  auto gcol = [&](int c) { return (c / U) * H + u0 + c % U; };

  for (int i = tid; i < NA * H; i += THREADS) {
    const int k = i / NA, c = i % NA;
    wg_s[c * LD + k] = wg[(size_t)k * 2 * H + gcol(c)];
  }
  for (int i = tid; i < NB * H; i += THREADS) {
    const int k = i / NB, c = i % NB;
    wc_s[c * LD + k] = wc[(size_t)k * H + u0 + c];
  }
  __syncthreads();

  // phase A: one thread per (column, row); phase B: per (column, row, k part)
  const int colA = tid % NA, rowA = tid / NA;
  const int colB = tid % NB, rowB = (tid / NB) % ROWS, part = tid / (NB * ROWS);
  const float bA = bias[gcol(colA)];
  const float4* wA = reinterpret_cast<const float4*>(wg_s + colA * LD);
  const float4* wB = reinterpret_cast<const float4*>(wc_s + colB * LD);

  for (int t = 0; t < T; ++t) {
    // ---- phase A: z and r of this block's units, r*h_{t-1} to scratch
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      const int nrows = min(ROWS, B - b0);
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
        reinterpret_cast<float4*>(tile + r * LD)[k4] = v;
      }
      __syncthreads();

      if (rowA < nrows) {
        const float4* hrow = reinterpret_cast<const float4*>(tile + rowA * LD);
        float acc = 0.f;
        for (int k4 = 0; k4 < H_4; ++k4) {
          const float4 wv = wA[k4], hv = hrow[k4];
          acc = fmaf(hv.x, wv.x, acc);
          acc = fmaf(hv.y, wv.y, acc);
          acc = fmaf(hv.z, wv.z, acc);
          acc = fmaf(hv.w, wv.w, acc);
        }
        const size_t bt = (size_t)(b0 + rowA) * T + t;
        prod[rowA * NA + colA] = (x3[bt * H3 + gcol(colA)] + acc) + bA;
      }
      __syncthreads();

      if (tid < nrows * U) {
        const int r = tid / U, uu = tid % U, j = u0 + uu;
        const size_t row = (size_t)(b0 + r) * H + j;
        const float z = sigm(prod[r * NA + uu]);
        const float rg = sigm(prod[r * NA + U + uu]);
        rh[row] = rg * tile[r * LD + j];
        zbuf[row] = z;
        if (gates != nullptr) {
          const size_t bt = (size_t)(b0 + r) * T + t;
          gates[bt * H3 + j] = z;
          gates[bt * H3 + H + j] = rg;
        }
      }
      __syncthreads();  // tile and prod are refilled by the next tile
    }
    grid.sync();        // all of r*h_{t-1} written before any block reads it

    // ---- phase B: the candidate and h_t of this block's units
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      const int nrows = min(ROWS, B - b0);
      for (int i = tid; i < nrows * H_4; i += THREADS) {
        const int r = i / H_4, k4 = i % H_4;
        reinterpret_cast<float4*>(tile + r * LD)[k4] = __ldcg(
            reinterpret_cast<const float4*>(rh + (size_t)(b0 + r) * H) + k4);
      }
      __syncthreads();

      if (rowB < nrows) {
        const float4* rrow = reinterpret_cast<const float4*>(tile + rowB * LD);
        float acc = 0.f;
        for (int k4 = part; k4 < H_4; k4 += KS) {
          const float4 wv = wB[k4], hv = rrow[k4];
          acc = fmaf(hv.x, wv.x, acc);
          acc = fmaf(hv.y, wv.y, acc);
          acc = fmaf(hv.z, wv.z, acc);
          acc = fmaf(hv.w, wv.w, acc);
        }
        prod[(part * ROWS + rowB) * NB + colB] = acc;
      }
      __syncthreads();

      if (tid < nrows * U) {
        const int r = tid / U, uu = tid % U, j = u0 + uu;
        const size_t bt = (size_t)(b0 + r) * T + t;
        float acc = 0.f;
#pragma unroll
        for (int p = 0; p < KS; ++p) acc += prod[(p * ROWS + r) * NB + uu];
        const float c =
            tanhf((x3[bt * H3 + 2 * H + j] + acc) + bias[2 * H + j]);
        if (gates != nullptr) gates[bt * H3 + 2 * H + j] = c;
        float h_prev = 0.f;
        if (t > 0) {
          h_prev = __ldcg(hs + (bt - 1) * H + j);
          if (reset != nullptr) h_prev *= 1.f - reset[bt];
        }
        const float z = __ldcg(zbuf + (size_t)(b0 + r) * H + j);
        const float h_new = z * h_prev + (1.f - z) * c;
        const float m = mask[bt];
        hs[bt * H + j] = m * h_new + (1.f - m) * h_prev;
      }
      __syncthreads();
    }
    grid.sync();        // hs[:, t] complete, and rh free, for step t+1
  }
}

// on the calling thread's current device, which the wrapper sets
cudaError_t prepare(int H) {
  return cudaFuncSetAttribute(gru_fwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(H));
}

}  // namespace

extern "C" {

// Blocks of gru_fwd_kernel that can be resident at once on the current
// device for hidden size H (any batch B: the kernel tiles it); a negative
// value is minus a cudaError_t. The launch needs H/U of them.
int gru_fwd_max_coresident_blocks(int B, int H) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -(int)err;
  err = prepare(H);
  if (err != cudaSuccess) return -(int)err;
  int coop = 0, sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (err != cudaSuccess) return -(int)err;
  if (!coop) return 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return -(int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gru_fwd_kernel, THREADS, smem_bytes(H));
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// Launches the recurrence on `stream` of the current device; returns the
// cudaError_t of the launch (0 on success). `reset` and `gates` (the stash)
// may be NULL; `scratch` holds 2*B*H floats.
int gru_fwd(const float* x3, const float* wg, const float* wc,
            const float* bias, const float* mask, const float* reset,
            float* hs, float* gates, float* scratch, int B, int T, int H,
            void* stream) {
  cudaError_t err = prepare(H);
  if (err != cudaSuccess) return (int)err;
  float* rh = scratch;
  float* zbuf = scratch + (size_t)B * H;
  void* args[] = {(void*)&x3,    (void*)&wg,    (void*)&wc, (void*)&bias,
                  (void*)&mask,  (void*)&reset, (void*)&hs, (void*)&gates,
                  (void*)&rh,    (void*)&zbuf,  (void*)&B,  (void*)&T,
                  (void*)&H};
  err = cudaLaunchCooperativeKernel((const void*)gru_fwd_kernel,
                                    dim3(H / U), dim3(THREADS), args,
                                    smem_bytes(H), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* gru_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
