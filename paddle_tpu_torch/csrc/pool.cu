// Max-pool backward, kernel 3 / stride 2 / symmetric pad 1, NHWC, for
// Hopper (sm_90a), bound to Python through ctypes.
//
// Replaces: paddle_tpu/kernels/pool.py `_bwd_kernel` (:53, launched by
// `_maxpool_bwd_pallas`), the Pallas TPU kernel that holds one [H, W, C]
// image in VMEM, recomputes the pooled maxima from it and sums each input
// position's gradient over the <= 4 windows that contain it, vectorised by
// row and column parity. It is the reference's hl_maxpool_backward
// (paddle/cuda/src/hl_cuda_cnn.cu) in form: a gather, not a scatter.
//
// What maxpool_bwd computes, HO = H/2, WO = W/2, window (o, p) covering
// rows 2o-1..2o+1 and columns 2p-1..2p+1 of the image (padding is -inf):
//   y[o, p]      = max over the window, NaN if any element is NaN (the
//                  max of jnp.maximum; CUDA's fmaxf would drop the NaN)
//   term(o, p)   = dy[o, p] * (x[r, c] == y[o, p] ? 1 : 0) inside the
//                  pooled grid, +0 outside it
//   dx[r, c]     = the terms of the windows containing (r, c), summed as
//                  the plain version (and the TPU kernel) sums them: an
//                  even row or column lies in window r/2 (c/2) only, an odd
//                  one in r/2 and r/2 + 1; for an odd column the two
//                  column windows are added first, for an odd row the
//                  upper window row's sum then the lower's:
//                    ((o, p) + (o, p+1)) + ((o+1, p) + (o+1, p+1))
//                  with the terms outside the grid as +0, so the kernel
//                  equals the plain version bit for bit.
// Every tied position gets the full gradient (the reference's `in ==
// out`), not torch's first argmax. The maxima come from x: no y is read.
//
// Layout: x and dx [B, H, W, C], dy [B, HO, WO, C]; float32, contiguous;
// H and W even (the function's geometry: HO = H/2, as the TPU kernel's
// row-parity split assumes); B * HO * WO * C < 2^31, the count of 2 x 2
// blocks, which a thread indexes in 32 bits (memory offsets are 64-bit).
// C needs no multiple of 64 (the TPU's lane width) and no image need fit
// a block's memory (the TPU's VMEM clause): a thread reads what it needs
// through L1 and L2.
//
// Bound on an H100 SXM at the ResNet-50 stem pool, x [256, 112, 112, 64]:
// read x (822.1 MB) and dy (205.5 MB), write dx (822.1 MB): 0.552 ms at
// 3.35 TB/s. Bytes bound it: some 10 compares a window, under 0.1 ms of
// operations.
//
// Design. One thread a 2 x 2 block of input positions (rows 2o, 2o+1,
// columns 2p, 2p+1) of one channel, channels fastest, so a warp's loads
// and stores are 32 neighbouring floats. The thread loads the 5 x 5 patch
// of x around its block once (25 loads for 4 outputs, through L1: the
// patches of neighbouring blocks overlap), recomputes the maxima of the 4
// windows that can contain its positions (o..o+1, p..p+1), reads their dy
// and writes its four sums: deterministic, no atomics, no shared memory.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;

// the max of jnp.maximum: NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__global__ void __launch_bounds__(THREADS)
maxpool_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dy,
                   float* __restrict__ dx, int B, int H, int W, int C) {
  const int HO = H / 2, WO = W / 2;
  const unsigned i = blockIdx.x * THREADS + threadIdx.x;
  if (i >= (unsigned)B * HO * WO * C) return;
  // (b, o, p, ch): input rows 2o, 2o+1 and columns 2p, 2p+1
  const int ch = (int)(i % C);
  unsigned rest = i / C;
  const int p = (int)(rest % WO);
  rest /= WO;
  const int o = (int)(rest % HO);
  const size_t b = rest / HO;
  const float* xi = x + b * H * W * C + ch;
  const float* gi = dy + b * HO * WO * C + ch;
  // the 5 x 5 patch of rows 2o-1..2o+3 and columns 2p-1..2p+3, -inf
  // outside the image
  float patch[5][5];
#pragma unroll
  for (int u = 0; u < 5; ++u)
#pragma unroll
    for (int v = 0; v < 5; ++v) {
      const int r = 2 * o - 1 + u, c = 2 * p - 1 + v;
      patch[u][v] = (r >= 0 && r < H && c >= 0 && c < W)
                        ? xi[((size_t)r * W + c) * C]
                        : -INFINITY;
    }
  // window (o+a, p+c): patch rows 2a..2a+2, columns 2c..2c+2; its dy,
  // +0 (and its terms +0) outside the pooled grid
  float y[2][2], g[2][2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      float m = -INFINITY;
#pragma unroll
      for (int u = 0; u < 3; ++u)
#pragma unroll
        for (int v = 0; v < 3; ++v) m = max_nan(m, patch[2 * a + u][2 * c + v]);
      y[a][c] = m;
      const bool in = o + a < HO && p + c < WO;
      g[a][c] = in ? gi[((size_t)(o + a) * WO + p + c) * C] : 0.f;
    }
  auto term = [&](int a, int c, float xv) -> float {
    if (o + a >= HO || p + c >= WO) return 0.f;
    return g[a][c] * (xv == y[a][c] ? 1.f : 0.f);
  };
  float* out = dx + b * H * W * C + ch + ((size_t)(2 * o) * W + 2 * p) * C;
  const size_t row = (size_t)W * C;
  const float x00 = patch[1][1], x01 = patch[1][2], x10 = patch[2][1],
              x11 = patch[2][2];
  out[0] = term(0, 0, x00);
  out[C] = term(0, 0, x01) + term(0, 1, x01);
  out[row] = term(0, 0, x10) + term(1, 0, x10);
  out[row + C] = (term(0, 0, x11) + term(0, 1, x11)) +
                 (term(1, 0, x11) + term(1, 1, x11));
}

}  // namespace

extern "C" {

// Launch on `stream` of the current device; return the cudaError_t of the
// launch (0 on success).
int maxpool_bwd(const float* x, const float* dy, float* dx, int B, int H,
                int W, int C, void* stream) {
  if (B < 1 || H < 2 || W < 2 || C < 1 || (H & 1) || (W & 1))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * (H / 2) * (W / 2) * C;
  if (total >= (1ull << 31)) return (int)cudaErrorInvalidValue;
  maxpool_bwd_kernel<<<(unsigned)((total + THREADS - 1) / THREADS), THREADS,
                       0, (cudaStream_t)stream>>>(x, dy, dx, B, H, W, C);
  return (int)cudaGetLastError();
}

const char* maxpool_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
