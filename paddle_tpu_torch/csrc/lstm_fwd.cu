// Fused LSTM forward for Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/lstm.py `_fwd_kernel` (launched by
// `_fwd_call`), the Pallas TPU kernel behind `fused_lstm`'s forward. It
// computes the same thing: the masked LSTM recurrence over a padded batch,
// gate order [i, f, c, o], peepholes at bias[4H:7H], the mask-gated carry
// (h_t = m*h_new + (1-m)*h_{t-1}, the same for c) and the optional
// segment-start reset that zeroes the carry entering a step. It writes hs
// and cs and, when training asks for it (a non-NULL `gates`), the stash of
// post-activation gates [i, f, g, o] that the backward (lstm_bwd.cu) reads.
// The stash is written at every step, padded ones too: the backward
// multiplies by the mask rather than selecting, and 0 * garbage may be NaN.
//
// Layout: batch-major x4 [B, T, 4H], mask and reset [B, T], W [H, 4H],
// bias [7H], hs and cs [B, T, H], gates [B, T, 4H]; all float32, all
// contiguous.
//
// Bound on an H100 SXM: the recurrent product h_{t-1} @ W costs
// 2*B*T*H*4H flops (13.4 GFLOP at B=64, T=100, H=512), done in float32 on
// the CUDA cores (67 TFLOP/s): about 0.2 ms. The bytes it must move (x4
// read once, hs and cs written once, W once: about 83 MB at that shape)
// take about 0.025 ms at 3.35 TB/s. So operations bound it, and the time
// loop is serial: each step needs all of h_{t-1} before any of h_t.
// PERF.md holds this kernel's measured times beside that bound
// (chip_smoke.py); they sit well above it, set by the per-step grid
// barrier and by one pass over H per block and step.
//
// Design. The TPU kernel keeps all of W in VMEM; at H=512, W is 4 MiB in
// float32 and one SM has at most 227 KB of shared memory. So W is split
// across blocks: block j owns hidden units [4j, 4j+4) and keeps those
// units' 16 columns of W (4 gates x 4 units, H x 16 floats) in shared
// memory for the whole launch. Its units' cell state is written and read
// back by this block alone (cs[:, t-1] of its own units), so only h
// crosses blocks. Each step a block stages h_{t-1} (written by
// every block into hs[:, t-1]) into shared memory, forms its 16 columns of
// the pre-activation for every batch row, applies the gate math for its
// units and writes its slice of hs[:, t] and cs[:, t].
//
// Step synchronisation: ONE persistent cooperative launch
// (cudaLaunchCooperativeKernel) with grid.sync() between timesteps, not one
// launch per step. W is then read from device memory once per call rather
// than once per step, and a step costs a grid barrier (about a microsecond)
// rather than a kernel launch. The price is that every block must be
// resident at once: H/4 blocks, checked against the occupancy API before
// each launch (lstm_fwd_max_coresident_blocks); the Python wrapper raises
// when they are not.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int U = 4;                  // hidden units per block
constexpr int NCOL = 4 * U;           // W columns per block (4 gates x U)
constexpr int THREADS = 256;
constexpr int RG = THREADS / NCOL;    // row groups: threads per column
constexpr int RPT = 2;                // batch rows per thread
constexpr int ROWS = RG * RPT;        // batch rows per tile

// shared memory: W columns [NCOL][H+4] (transposed, so a thread reads its
// column as float4 runs along k; the +4 pad spreads the columns over the
// banks), h_{t-1} tile [ROWS][H+4], pre-activations [ROWS][NCOL]
size_t smem_bytes(int H) {
  return sizeof(float) *
         ((size_t)(NCOL + ROWS) * (H + 4) + (size_t)ROWS * NCOL);
}

__device__ __forceinline__ float sigm(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(THREADS)
lstm_fwd_kernel(const float* __restrict__ x4, const float* __restrict__ w,
                const float* __restrict__ bias,
                const float* __restrict__ mask,
                const float* __restrict__ reset, float* hs, float* cs,
                float* __restrict__ gates, int B, int T, int H) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int LD = H + 4;
  float* w_s = smem;                  // w_s[c*LD + k] = W[k, gcol(c)]
  float* h_s = w_s + NCOL * LD;       // h_s[r*LD + k] = h_{t-1}[b0+r, k]
  float* pre_s = h_s + ROWS * LD;     // pre_s[r*NCOL + c]

  const int tid = threadIdx.x;
  const int u0 = blockIdx.x * U;      // first hidden unit of this block
  const int col = tid % NCOL;         // gate col / U, unit col % U
  const int rg = tid / NCOL;
  const size_t H4 = 4 * (size_t)H;
  const int H_4 = H / 4;
  // column of x4 / W / bias that local column c stands for
  auto gcol = [&](int c) { return (c / U) * H + u0 + c % U; };

  // W's columns stay in shared memory for the whole recurrence
  for (int i = tid; i < NCOL * H; i += THREADS) {
    const int k = i / NCOL, c = i % NCOL;
    w_s[c * LD + k] = w[(size_t)k * H4 + gcol(c)];
  }
  const float b_col = bias[gcol(col)];
  __syncthreads();

  const float4* w_col = reinterpret_cast<const float4*>(w_s + col * LD);
  for (int t = 0; t < T; ++t) {
    for (int b0 = 0; b0 < B; b0 += ROWS) {
      const int nrows = min(ROWS, B - b0);
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
      float acc[RPT];
#pragma unroll
      for (int j = 0; j < RPT; ++j) acc[j] = 0.f;
      for (int k4 = 0; k4 < H_4; ++k4) {
        const float4 wv = w_col[k4];
#pragma unroll
        for (int j = 0; j < RPT; ++j) {
          const float4 hv =
              reinterpret_cast<const float4*>(h_s + (rg + j * RG) * LD)[k4];
          acc[j] = fmaf(hv.x, wv.x, acc[j]);
          acc[j] = fmaf(hv.y, wv.y, acc[j]);
          acc[j] = fmaf(hv.z, wv.z, acc[j]);
          acc[j] = fmaf(hv.w, wv.w, acc[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < RPT; ++j) {
        const int r = rg + j * RG;
        if (r < nrows) {
          const size_t bt = (size_t)(b0 + r) * T + t;
          pre_s[r * NCOL + col] = (x4[bt * H4 + gcol(col)] + acc[j]) + b_col;
        }
      }
      __syncthreads();

      // gate math and the mask-gated carry: one thread per (row, unit)
      if (tid < nrows * U) {
        const int r = tid / U, uu = tid % U, j = u0 + uu;
        const size_t bt = (size_t)(b0 + r) * T + t;
        const float m = mask[bt];
        const float h_prev = h_s[r * LD + j];
        float c_prev = 0.f;
        if (t > 0) {
          c_prev = __ldcg(cs + (bt - 1) * H + j);
          if (reset != nullptr) c_prev *= 1.f - reset[bt];
        }
        const float* pr = pre_s + r * NCOL;
        const float ig = sigm(pr[uu] + bias[4 * H + j] * c_prev);
        const float fg = sigm(pr[U + uu] + bias[5 * H + j] * c_prev);
        const float gg = tanhf(pr[2 * U + uu]);
        const float c_new = fg * c_prev + ig * gg;
        const float og = sigm(pr[3 * U + uu] + bias[6 * H + j] * c_new);
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

// on the calling thread's current device, which the wrapper sets
cudaError_t prepare(int H) {
  return cudaFuncSetAttribute(lstm_fwd_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(H));
}

}  // namespace

extern "C" {

// Blocks of lstm_fwd_kernel that can be resident at once on the current
// device for hidden size H (any batch B: the kernel tiles it); a negative
// value is minus a cudaError_t. The launch needs H/U of them.
int lstm_fwd_max_coresident_blocks(int B, int H) {
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
      &per_sm, lstm_fwd_kernel, THREADS, smem_bytes(H));
  if (err != cudaSuccess) return -(int)err;
  return per_sm * sms;
}

// Launches the recurrence on `stream` of the current device; returns the
// cudaError_t of the launch (0 on success). `reset` and `gates` may be
// NULL (no reset; no stash, as serving runs it).
int lstm_fwd(const float* x4, const float* w, const float* bias,
             const float* mask, const float* reset, float* hs, float* cs,
             float* gates, int B, int T, int H, void* stream) {
  cudaError_t err = prepare(H);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {(void*)&x4,   (void*)&w,  (void*)&bias, (void*)&mask,
                  (void*)&reset, (void*)&hs, (void*)&cs,   (void*)&gates,
                  (void*)&B,     (void*)&T,  (void*)&H};
  err = cudaLaunchCooperativeKernel((const void*)lstm_fwd_kernel,
                                    dim3(H / U), dim3(THREADS), args,
                                    smem_bytes(H), (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

const char* lstm_fwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
