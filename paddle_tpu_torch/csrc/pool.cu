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
// row-parity split assumes); B * HO * WO * C < 2^31 (the thread kernel
// numbers its 2 x 2 blocks in 32 bits; memory offsets are 64-bit). C needs
// no multiple of 64 (the TPU's lane width) and no image need fit a block's
// memory (the TPU's VMEM clause).
//
// Bound on an H100 SXM at the ResNet-50 stem pool, x [256, 112, 112, 64]:
// read x (822.1 MB) and dy (205.5 MB), write dx (822.1 MB): 0.552 ms at
// 3.35 TB/s. Bytes bound it: some 10 compares a window, under 0.1 ms of
// operations.
//
// Design: two kernels, chosen by the caller's plan (kernels/pool.py
// maxpool_bwd_plan, from the shape and the pointers alone).
//
// maxpool_bwd_strip_kernel (plan 1; C % 4 == 0 and 16-byte aligned x, dy
// and dx): a block owns one image's strip of TW window columns over a
// slice of up to LANES float4s of channels, thread (p, v) window column p
// and channel float4 v, and walks down the HO window rows. Window row o
// finishes dx rows 2o-1 (windows o-1 and o) and 2o (window o alone), and
// the last one row H-1 too; window column p finishes dx columns 2p and
// 2p+1. So every dx element is written by one thread, once, as part of a
// float4, and a warp's stores are whole 128-byte lines at C = 64. At each
// window row the block stages x rows 2o and 2o+1 (over the strip's 2TW+3
// columns from 2 p0 - 1, the halo one window) and dy row o into shared
// memory by 16-byte cp.async, STAGES window rows deep, so the next row
// loads while this one computes: x and dy cross device memory once (the
// halo columns the neighbouring strip's block, which runs beside this one,
// finds in L2). Each window's max is formed once (the halo window's by
// the strip on either side) into shared memory, from its three rows' 3-
// column maxima, of which the last is kept in a register for the next
// window row; a thread keeps its x, maxima and dy of window row o in
// registers for row o+1. Padding is -inf only at the image's edge: the
// max leaves out row -1 and column -1, so staging needs no fill. On an
// H100 at the stem pool (tools/torch_pool_bwd_levers.py): TW = 8 and 16
// alike, 4 4% slower; a 16-float4 slice 6% ahead of 8; 2 stages 2% ahead
// of 3 (26 KiB a block, not 38: 8 blocks an SM, not 5); plain float4 loads
// through registers in place of cp.async 35 to 57% slower; 8 to 10% above
// a copy of the same bytes.
//
// maxpool_bwd_thread_kernel (plan 0: any C, any alignment): one thread a
// 2 x 2 block of input positions (rows 2o, 2o+1, columns 2p, 2p+1) of one
// channel, channels fastest, so a warp's loads and stores are 32
// neighbouring floats. The thread loads the 5 x 5 patch of x around its
// block once (25 loads for 4 outputs, through L1: the patches of
// neighbouring blocks overlap), recomputes the maxima of the 4 windows
// that can contain its positions (o..o+1, p..p+1), reads their dy and
// writes its four sums: deterministic, no atomics, no shared memory.

#include <cuda_runtime.h>
#include <math.h>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;   // the thread kernel's block
constexpr int LANES = 16;      // a strip's channel slice: 16 float4s
constexpr int STAGES = 2;      // window rows staged: this one and the next
constexpr int TW = 8;          // window columns a strip

// the max of jnp.maximum: NaN if either is NaN
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float4 max4(float4 a, float4 b) {
  return make_float4(max_nan(a.x, b.x), max_nan(a.y, b.y),
                     max_nan(a.z, b.z), max_nan(a.w, b.w));
}

// one window's gradient term at x, per channel: dy * (x == its max)
__device__ __forceinline__ float4 term4(float4 g, float4 x, float4 y) {
  return make_float4(g.x * (x.x == y.x ? 1.f : 0.f),
                     g.y * (x.y == y.y ? 1.f : 0.f),
                     g.z * (x.z == y.z ? 1.f : 0.f),
                     g.w * (x.w == y.w ? 1.f : 0.f));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// 16 bytes of device memory into shared memory, with no register between
__device__ __forceinline__ void stage16(float4* dst, const float4* src) {
  cp_async16(reinterpret_cast<float*>(dst),
             reinterpret_cast<const float*>(src));
}

// float4s of shared memory a strip block uses: x rows [STAGES][2][2TW+3]
// [V], dy rows [STAGES][TW+1][V], the window maxima [TW+1][V]; 26368
// bytes at V = LANES
size_t strip_smem_float4s(int V) {
  return (size_t)V * (STAGES * 2 * (2 * TW + 3) + (STAGES + 1) * (TW + 1));
}

// See the note at the top of the file. x, dy and dx as float4s, C4 = C/4;
// TW * V threads, V = min(C4, LANES)
__global__ void maxpool_bwd_strip_kernel(const float4* __restrict__ x,
                                         const float4* __restrict__ dy,
                                         float4* __restrict__ dx, int H,
                                         int W, int C4, int V) {
  extern __shared__ float4 smem[];
  const int HO = H / 2, WO = W / 2, XC = 2 * TW + 3;
  const int strips = (WO + TW - 1) / TW, slices = (C4 + V - 1) / V;
  const int strip = (int)(blockIdx.x % strips);
  const unsigned rest = blockIdx.x / strips;
  const int slice = (int)(rest % slices);
  const size_t b = rest / slices;
  const int p0 = strip * TW;
  const int v = threadIdx.x % V, p = threadIdx.x / V;
  const int cv = slice * V + v;          // this thread's channel float4
  const bool cok = cv < C4;
  const int gp = p0 + p;                 // its window column
  const bool own = cok && gp < WO;
  const bool right = gp + 1 < WO;        // window gp+1 is in the grid
  const bool halo = cok && p == 0 && p0 + TW < WO;  // window p0 + TW too

  float4* xs = smem;                           // [STAGES][2][XC][V]
  float4* gs = xs + STAGES * 2 * XC * V;       // [STAGES][TW + 1][V]
  float4* ys = gs + STAGES * (TW + 1) * V;     // [TW + 1][V]
  const float4* xb = x + b * H * W * C4 + cv;
  const float4* gb = dy + b * HO * WO * C4 + cv;
  float4* db = dx + b * H * W * C4 + cv;

  // x rows 2s and 2s+1 and dy row s into stage s % STAGES: one commit
  // group, empty past the last window row. Thread (p, v) copies the
  // positions p, p + TW, ... of the stage's 2 XC + TW + 1
  auto issue = [&](int s) {
    if (s < HO && cok) {
      float4* xd = xs + (s % STAGES) * 2 * XC * V + v;
      float4* gd = gs + (s % STAGES) * (TW + 1) * V + v;
      for (int q = p; q < 2 * XC + TW + 1; q += TW) {
        if (q < 2 * XC) {
          const int lower = q >= XC, c = 2 * p0 - 1 + q - lower * XC;
          if (c >= 0 && c < W)
            stage16(xd + q * V, xb + ((size_t)(2 * s + lower) * W + c) * C4);
        } else {
          const int c = p0 + q - 2 * XC;
          if (c < WO) stage16(gd + (q - 2 * XC) * V,
                              gb + ((size_t)s * WO + c) * C4);
        }
      }
    }
    cp_async_commit();
  };

  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  // carried from window row o-1: x row 2o-1 at columns 2gp and 2gp+1, the
  // 3-column maxima of that row at window gp and at the halo window, the
  // maxima and dy of windows gp and gp+1
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  float4 xu0 = zero, xu1 = zero, hu = zero, hh = zero, yu0 = zero,
         yu1 = zero, gu0 = zero, gu1 = zero;
  for (int o = 0; o < HO; ++o) {
    cp_async_wait<STAGES - 2>();         // stage o has landed ...
    __syncthreads();                     // ... for every thread, and row
                                         // o-1 is done with its stage
    issue(o + STAGES - 1);
    const float4* xr = xs + (o % STAGES) * 2 * XC * V + v;  // rows 2o, 2o+1
    const float4* gr = gs + (o % STAGES) * (TW + 1) * V + v;
    // window row o's maxima, column 2gp - 1 left out at gp = 0 and row
    // 2o - 1 at o = 0 (the -inf padding)
    float4 xe0 = zero, xe1 = zero, xd0 = zero, xd1 = zero, y0 = zero;
    const int j = 2 * p;                 // the local column of 2gp - 1
    if (own) {
      xe0 = xr[(j + 1) * V];
      xe1 = xr[(j + 2) * V];
      xd0 = xr[(XC + j + 1) * V];
      xd1 = xr[(XC + j + 2) * V];
      float4 h0 = max4(xe0, xe1), h1 = max4(xd0, xd1);
      if (gp > 0) {
        h0 = max4(h0, xr[j * V]);
        h1 = max4(h1, xr[(XC + j) * V]);
      }
      y0 = o > 0 ? max4(max4(hu, h0), h1) : max4(h0, h1);
      hu = h1;
      ys[p * V + v] = y0;
    }
    if (halo) {
      const int k = 2 * TW;
      const float4 h0 = max4(max4(xr[k * V], xr[(k + 1) * V]),
                             xr[(k + 2) * V]);
      const float4 h1 = max4(max4(xr[(XC + k) * V], xr[(XC + k + 1) * V]),
                             xr[(XC + k + 2) * V]);
      ys[TW * V + v] = o > 0 ? max4(max4(hh, h0), h1) : max4(h0, h1);
      hh = h1;
    }
    __syncthreads();
    if (!own) continue;
    // windows gp and gp+1 of row o; past the grid a +0 term (dy 0)
    const float4 g0 = gr[p * V];
    const float4 y1 = right ? ys[(p + 1) * V + v] : zero;
    const float4 g1 = right ? gr[(p + 1) * V] : zero;
    float4* de = db + ((size_t)(2 * o) * W + 2 * gp) * C4;
    // row 2o: window o alone; column 2gp+1 also window gp+1
    de[0] = term4(g0, xe0, y0);
    de[C4] = add4(term4(g0, xe1, y0), term4(g1, xe1, y1));
    if (o > 0) {                         // row 2o-1: windows o-1 and o
      float4* du = de - (size_t)W * C4;
      du[0] = add4(term4(gu0, xu0, yu0), term4(g0, xu0, y0));
      du[C4] = add4(add4(term4(gu0, xu1, yu0), term4(gu1, xu1, yu1)),
                    add4(term4(g0, xu1, y0), term4(g1, xu1, y1)));
    }
    if (o == HO - 1) {                   // row H-1: window o, then +0
      float4* dd = de + (size_t)W * C4;
      dd[0] = add4(term4(g0, xd0, y0), zero);
      dd[C4] = add4(add4(term4(g0, xd1, y0), term4(g1, xd1, y1)), zero);
    }
    xu0 = xd0;
    xu1 = xd1;
    yu0 = y0;
    yu1 = y1;
    gu0 = g0;
    gu1 = g1;
  }
}

__global__ void __launch_bounds__(THREADS)
maxpool_bwd_thread_kernel(const float* __restrict__ x,
                          const float* __restrict__ dy,
                          float* __restrict__ dx, int B, int H, int W,
                          int C) {
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

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Launch on `stream` of the current device: plan 0 the thread kernel,
// plan 1 the strip kernel (C % 4 == 0 and 16-byte aligned pointers);
// return the cudaError_t of the launch (0 on success).
int maxpool_bwd(const float* x, const float* dy, float* dx, int B, int H,
                int W, int C, int plan, void* stream) {
  if (B < 1 || H < 2 || W < 2 || C < 1 || (H & 1) || (W & 1))
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)B * (H / 2) * (W / 2) * C;
  if (total >= (1ull << 31)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (plan == 0) {
    maxpool_bwd_thread_kernel<<<(unsigned)((total + THREADS - 1) / THREADS),
                                THREADS, 0, st>>>(x, dy, dx, B, H, W, C);
    return (int)cudaGetLastError();
  }
  if (plan != 1 || C % 4 || !aligned16(x) || !aligned16(dy) ||
      !aligned16(dx))
    return (int)cudaErrorInvalidValue;
  const int C4 = C / 4, V = C4 < LANES ? C4 : LANES;
  const unsigned blocks = (unsigned)B * ((C4 + V - 1) / V) *
                          ((W / 2 + TW - 1) / TW);
  const size_t smem = 16 * strip_smem_float4s(V);
  maxpool_bwd_strip_kernel<<<blocks, TW * V, smem, st>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(dy),
      reinterpret_cast<float4*>(dx), H, W, C4, V);
  return (int)cudaGetLastError();
}

const char* maxpool_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
