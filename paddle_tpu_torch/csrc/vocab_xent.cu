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
// D = 512, V = 30000: the logits' product is 2NDV = 235.9 GFLOP against
// 77 MB of inputs, 0.023 ms at 3.35 TB/s; each backward kernel recomputes
// the logits and forms one more product of the same size. The N*V
// exponentials (0.23 G) add under 1%. Operations bound all three. All
// three run their products on the tensor cores in three TF32 passes: the
// forward 707.8 GFLOP, 1.43 ms at the published 495 TFLOP/s; dx and dW
// 1415.6 GFLOP each, 2.86 ms, 2.8770 ms with dx's 5NV operations of dlog
// on the CUDA cores and 2.8804 with dW's 6NV (db adds dlog too). mma.sync
// reaches 322 TFLOP/s there (tools/torch_mma_tf32_rate.py): 2.20 ms for
// the forward, 4.40 ms for either backward kernel. In float32 outside the
// tensor cores (67 TFLOP/s) the forward alone would take 3.52 ms.
//
// Design. The TPU carries (m, l, gold) and the dx accumulator across a
// sequential V grid axis; on Hopper blocks run in parallel in no order.
// The tensor cores truncate each operand to TF32 (10 mantissa bits), which
// misses float32's tolerance by far, so each operand is split a = big +
// small and a product summed as big·small + small·big + big·big (the
// dropped small·small is some 2^-22 of it; test_torch_vocab_xent.py models
// the splits and sums of all three kernels against float64).
//   dw:   on the tensor cores, mma.sync m16n8k8 with TF32 operands, each
//         split a = big + small (big = tf32(a) rounded, as the tensor cores
//         would truncate; small = tf32(a - big)) and summed as big·small +
//         small·big + big·big: one TF32 pass misses the tolerance (some
//         4e-4 of dW's largest value), three keep float32's (test_torch_
//         vocab_xent.py models both). A block of 512 threads owns 64
//         columns and 512 rows of D (a second grid dimension takes D in
//         such chunks, each recomputing the logits) and loops over all row
//         tiles of 64 in order; its dW [512, 64] stays in registers, 64 a
//         thread, and is written once. Per tile: the logits over all of D
//         in depth steps of 32, x and w streamed by 16-byte cp.async
//         through a ring of 3 stages (4-byte copies where rows of D or V
//         floats are not 16-byte aligned, zero-fill past N, D and V); the
//         x steps of the block's D chunk land in a [64, 512] x tile that
//         then feeds x_tile^T @ dlog too, with no second read. dlog goes to
//         shared memory already split (big, exact small), db sums its
//         column in row order, and each warp adds x_tile^T @ dlog for its
//         32 rows of dW, a 16-row half at a time in fresh accumulators,
//         into the sums in float32: the tensor cores truncate every MMA's
//         float32 sum, and sums kept in the MMAs over all of N drifted to
//         3.7e-4 at (7680, 512, 30000) (2.96e-5 so). x is kept at r *
//         stride + (q ^ (r & 4)) with a stride of 8 mod 32, so both
//         products' fragments read 32 distinct banks. 469 blocks at V =
//         30000 are 3.55 waves of one block an SM; the last, partial wave
//         costs a whole one (15.78 ms against 15.71 at 4 full waves,
//         tools/torch_vocab_xent_dw_waves.py). 15.93 ms at (7680, 512,
//         30000) on an H100 80GB HBM3 at 700 W (chip_smoke.py), 3.6x
//         mma.sync's floor: each warp's logits are two chains of dependent
//         MMAs, and a tile waits at 18 block barriers.
//   dx:   dW's arithmetic with the roles of (x, rows) and (w, columns)
//         exchanged. A block of 256 threads owns 64 rows of x and one of S
//         vocabulary slices (a third grid dimension takes D in chunks of
//         512, each recomputing the logits); its dx [64, 512] stays in
//         registers, 128 a thread, over all of the slice's column tiles and
//         is written once into its slice's partial. Per column tile of 64:
//         the logits over all of D in k-chunks of 64, the block's D chunk
//         first, x by cp.async through a ring of 2 stages and w into a
//         [512, 64] w tile (144 KB) whose bits then feed dlog @ w_tile^T
//         too, read from device memory once (depths outside the D chunk
//         through a w ring in dlog's place); dlog^T to shared memory split;
//         then each warp adds w_tile @ dlog^T for its 64 columns of dx,
//         each 8-column step's three passes in fresh accumulators added in
//         float32 (kept inside the MMAs over V = 3000, the model in
//         test_torch_vocab_xent.py drifts 50 times as far). w is kept at d
//         * 72 + (c ^ (d & 4)), so the logits' fragments (rows t, columns
//         g) and the product's (rows g, columns t) both read 32 distinct
//         banks. The next tile's first two x chunks are copied during that
//         product, and each warp copies the next tile's w rows, which it
//         alone reads there, as soon as it is done with them. Operands are
//         split by clearing their low 13 bits (big) and subtracting
//         (small), a mask and a subtraction in place of dW's
//         cvt.rna.tf32.f32 conversion (test_torch_vocab_xent.py models
//         this split); the logits keep big·big and the small passes in
//         two accumulators, two chains a tile. Eight warps at up to 255
//         registers: sixteen would have 128 a thread, 64 of them dx's. S
//         fills one wave of one block an SM: 1 at the report shape (120
//         blocks, no sum; S = 2 to 6 take 8.98 to 9.20 ms with their sum
//         against 9.21 to 9.35, tools/torch_vocab_xent_slices.py). 9.20 to
//         9.22 ms at (7680, 512, 30000) on an H100 80GB HBM3 at 700 W
//         (chip_smoke.py), 48% of mma.sync's floor; the float32 FMA kernel
//         it replaced took 18.26.
//   fwd:  dx's logits without its second product. A block of 256 threads
//         (dx's 8 warps and their 16 x 32 logit tiles) owns 64 rows and
//         one of S vocabulary slices and loops over the slice's column
//         tiles of 64; per tile, the logits over all of D in k-chunks of
//         64, x and w both streamed by dx_copy through a ring of 3 stages,
//         copied two chunks ahead across tile ends; dx_logits_chunk's two
//         accumulators, added in float32 at the tile's end, plus the bias,
//         update each thread's online (m, l, gold) of its two rows over its
//         8 columns (columns >= V stay out; the label is compared with the
//         column, never used as an index). The 4 lanes and 2 warps sharing
//         a row combine their states at the end, in a fixed order, and the
//         slice's partials are written once; a second small kernel
//         combines the slices in order. 110.6 KB of shared memory and at
//         most 128 registers let two blocks share an SM; S gives some
//         eight waves of them, in slices of even length: a small last wave
//         (tools/torch_vocab_xent_slices.py sweeps S). The float32
//         FMA kernel it replaced took 7.43 ms at (7680, 512, 30000) on an
//         H100 80GB HBM3 at 700 W (chip_smoke.py).
// No atomics anywhere: two runs give the same bits. Shared memory: 111 KB
// (fwd: the ring), 216 KB (dx: w tile 144 KB, x ring 36 KB, dlog 36 KB),
// 223 KB (dw: x tile 130 KB, the two rings 57 KB, dlog 36 KB). Registers
// (nvcc -Xptxas -v): at most 128 (fwd, two blocks an SM; dw, 512
// threads), 255 (dx, 256 threads); no kernel spills. expf and logf are
// the accurate ones.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SLICE_COLS = 128;  // the forward's and dx's slices are whole
                                 // tiles of this many vocabulary columns

// the column tiles [lo, hi) of slice s of S over nvt tiles
__device__ __forceinline__ void slice_tiles(int nvt, int S, int s, int& lo,
                                            int& hi) {
  lo = (int)((long long)s * nvt / S);
  hi = (int)((long long)(s + 1) * nvt / S);
}

// one entry of dlog: (exp(logit + bias - lse) - onehot) * ct, exactly 0
// where the entry is not live (a row >= N or a column >= V: a select, as a
// row past N has no lse, and exp(bias) there may be inf); labels are
// compared with the column, never used as an index
__device__ __forceinline__ float dlog_value(float logit, float bias, float lse,
                                            float ct, int lab, int c,
                                            bool live) {
  const float p = expf(logit + bias - lse);
  return live ? (p - (c == lab ? 1.f : 0.f)) * ct : 0.f;
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

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }

__device__ __forceinline__ void add_to(float4& a, float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// dx = the S partials summed in slice order: T float4 where N*D % 4 == 0
// and both pointers are 16-byte aligned (total then counts float4s),
// float else, the same sums in the same order either way. A thread loads
// SUM_GROUP partials before it adds them in order, so that many loads are
// in flight, not one dependent load an add; one element a thread, SUM_
// THREADS a block (512 blocks, some 4 an SM, at [16, 512, 512]), the grid
// striding beyond SUM_MAX_BLOCKS
constexpr int SUM_THREADS = 128;
constexpr int SUM_GROUP = 16;
constexpr size_t SUM_MAX_BLOCKS = 32 * 132;

template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
vocab_xent_bwd_dx_reduce_kernel(const T* __restrict__ part,
                                T* __restrict__ dx, size_t total, int S) {
  for (size_t i = blockIdx.x * (size_t)SUM_THREADS + threadIdx.x; i < total;
       i += (size_t)gridDim.x * SUM_THREADS) {
    T v = part[i];
    for (int s0 = 1; s0 < S; s0 += SUM_GROUP) {
      T u[SUM_GROUP];
#pragma unroll
      for (int k = 0; k < SUM_GROUP; ++k)
        if (s0 + k < S) u[k] = part[(size_t)(s0 + k) * total + i];
#pragma unroll
      for (int k = 0; k < SUM_GROUP; ++k)
        if (s0 + k < S) add_to(v, u[k]);
    }
    dx[i] = v;
  }
}

// --- dW/db on the tensor cores (3xTF32 mma.sync) ----------------------------

constexpr int DW_THREADS = 512;  // 16 warps
constexpr int DW_BM = 64;        // rows of x a tile
constexpr int DW_BN = 64;        // columns of w, dW and db a block
constexpr int DW_DC = 512;       // rows of dW a block holds in registers
constexpr int DW_KC = 32;        // depth of one staged step of the logits
constexpr int DW_NS = 3;         // stages of the cp.async ring
constexpr int XS = DW_DC + 8;    // row of the x tile [DW_BM][XS]
constexpr int XRS = DW_KC + 8;   // row of an x ring stage [DW_BM][XRS]
constexpr int WS = DW_BN + 8;    // row of a w ring stage [DW_KC][WS] and
                                 // of the dlog tiles [DW_BM][WS]
constexpr int DW_SMEM = (DW_BM * XS + DW_NS * DW_BM * XRS +
                         DW_NS * DW_KC * WS + 2 * DW_BM * WS) * 4;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// cp.async of 16 bytes (of 4): with `ok` false it reads nothing and fills
// the destination with zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

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

// a rounded to TF32 (to nearest, ties away from 0), low 13 bits clear;
// the tensor cores ignore an operand's low 13 bits, so rounding happens
// here rather than truncation there
__device__ __forceinline__ unsigned tf32_bits(float a) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(a));
  return r;
}

// a = big + small, each rounded to TF32
__device__ __forceinline__ void split_tf32(float a, unsigned& big,
                                           unsigned& small) {
  big = tf32_bits(a);
  small = tf32_bits(a - __uint_as_float(big));
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

// Where k-chunk j of x (depths j*DW_KC ..) is staged, and its row stride:
// in the x tile when it lies in the block's dW rows [d0, d0 + DW_DC), for
// both products; else in ring stage j % DW_NS, for the logits only. Both
// keep x[r][q] at r * stride + (q ^ (r & 4)): with a stride of 8 mod 32
// the logits' fragments (rows g, columns t) and x^T's (rows t, columns g)
// both read 32 distinct banks.
__device__ __forceinline__ float* x_chunk(float* xt, float* xr, int j, int d0,
                                          int& stride) {
  const int k0 = j * DW_KC;
  if (k0 >= d0 && k0 < d0 + DW_DC) {
    stride = XS;
    return xt + (k0 - d0);
  }
  stride = XRS;
  return xr + (j % DW_NS) * DW_BM * XRS;
}

// start the copies of k-chunk j: x[r0 .., j*DW_KC ..] (64 x 32) and
// w[j*DW_KC .., c0 ..] (32 x 64); rows >= N, depths >= D and columns >= V
// are zero-filled. 16-byte copies where rows of D (V) floats keep them
// aligned (vec_x, vec_w), 4-byte copies else
__device__ __forceinline__ void stage_chunk(
    const float* __restrict__ x, const float* __restrict__ w, int N, int D,
    int V, int r0, int c0, int d0, int j, bool vec_x, bool vec_w, float* xt,
    float* xr, float* wr) {
  const int tid = threadIdx.x, k0 = j * DW_KC;
  int xs;
  float* xv = x_chunk(xt, xr, j, d0, xs);
  float* wv = wr + (j % DW_NS) * DW_KC * WS;
  if (vec_x) {
    const int r = tid >> 3, q = (tid & 7) * 4;
    const bool ok = r0 + r < N && k0 + q < D;
    cp_async16(xv + r * xs + (q ^ (r & 4)),
               ok ? x + (size_t)(r0 + r) * D + k0 + q : x, ok);
  } else {
    for (int e = tid; e < DW_BM * DW_KC; e += DW_THREADS) {
      const int r = e >> 5, q = e & 31;
      const bool ok = r0 + r < N && k0 + q < D;
      cp_async4(xv + r * xs + (q ^ (r & 4)),
                ok ? x + (size_t)(r0 + r) * D + k0 + q : x, ok);
    }
  }
  if (vec_w) {
    const int k = tid >> 4, q = (tid & 15) * 4;
    const bool ok = k0 + k < D && c0 + q < V;
    cp_async16(wv + k * WS + q, ok ? w + (size_t)(k0 + k) * V + c0 + q : w,
               ok);
  } else {
    for (int e = tid; e < DW_KC * DW_BN; e += DW_THREADS) {
      const int k = e >> 6, q = e & 63;
      const bool ok = k0 + k < D && c0 + q < V;
      cp_async4(wv + k * WS + q, ok ? w + (size_t)(k0 + k) * V + c0 + q : w,
                ok);
    }
  }
}

// lg += the chunk's share of the logits: warp (wm, wn) = (warp / 4, warp %
// 4) owns rows wm*16 .. +16 and columns wn*16 .. +16 of the 64 x 64 tile,
// two 16 x 8 tiles; xv, xs as x_chunk gives them, wv the chunk's w stage
__device__ __forceinline__ void logits_chunk(const float* xv, int xs,
                                             const float* wv,
                                             float lg[2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = (warp >> 2) * 16 + g, sw = ra & 4, n = (warp & 3) * 16 + g;
#pragma unroll
  for (int kk = 0; kk < DW_KC; kk += 8) {
    // columns kk + t and kk + t + 4, swizzled: (kk + t) ^ sw and so on
    unsigned ab[4], as[4];
    split_tf32(xv[ra * xs + kk + t + sw], ab[0], as[0]);
    split_tf32(xv[(ra + 8) * xs + kk + t + sw], ab[1], as[1]);
    split_tf32(xv[ra * xs + kk + t + 4 - sw], ab[2], as[2]);
    split_tf32(xv[(ra + 8) * xs + kk + t + 4 - sw], ab[3], as[3]);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      unsigned bb[2], bs[2];
      split_tf32(wv[(kk + t) * WS + n + nt * 8], bb[0], bs[0]);
      split_tf32(wv[(kk + t + 4) * WS + n + nt * 8], bb[1], bs[1]);
      mma_3xtf32(lg[nt], ab, as, bb, bs);
    }
  }
}

// acc += x_tile^T @ dlog for the warp's 32 rows of dW (m0 .. m0 + 32 of the
// block's) and all 64 columns: 2 x 8 tiles of 16 x 8, over the tile's 64
// rows of x; A = x^T read from the x tile, B = dlog's two parts (big, and
// small = dlog - big, exact in float32; the tensor cores read its top 10
// mantissa bits, an error of the order of the dropped small·small term).
// Each 16-row half's sum over the tile forms in fresh accumulators and is
// added to acc in float32: the tensor cores truncate each MMA's float32
// sum, so sums kept inside the MMAs over all N rows would drift by up to
// an ulp for every 8 rows and pass
__device__ __forceinline__ void dw_tile(const float* xt, const float* dlb,
                                        const float* dls, int m0,
                                        float acc[2][8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int m = m0 + mt * 16 + g;
    float part[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[nt][i] = 0.f;
#pragma unroll 1
    for (int r = 0; r < DW_BM; r += 8) {
      // x rows r + t (swizzle 0) and r + t + 4 (swizzle 4)
      const float* x0 = xt + (r + t) * XS;
      const float* x4 = xt + (r + t + 4) * XS;
      unsigned ab[4], as[4];
      split_tf32(x0[m], ab[0], as[0]);
      split_tf32(x0[m + 8], ab[1], as[1]);
      split_tf32(x4[m ^ 4], ab[2], as[2]);
      split_tf32(x4[(m + 8) ^ 4], ab[3], as[3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int i0 = (r + t) * WS + nt * 8 + g, i1 = i0 + 4 * WS;
        const unsigned bb[2] = {__float_as_uint(dlb[i0]),
                                __float_as_uint(dlb[i1])};
        const unsigned bs[2] = {__float_as_uint(dls[i0]),
                                __float_as_uint(dls[i1])};
        mma_3xtf32(part[nt], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[nt][i];
  }
}

// grid (column tiles of 64, D chunks of 512): the block's dW [512, 64]
// stays in registers (64 a thread) over all row tiles, a tile's sum added
// in float32 (dw_tile), and is written once;
// each row tile recomputes its logits over all of D, so a D chunk past the
// first repeats them. db (chunk 0's blocks) sums each tile's column in row
// order. Shared memory: the x tile, the two rings and dlog, DW_SMEM bytes.
__global__ void __launch_bounds__(DW_THREADS, 1)
vocab_xent_bwd_dw_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ b,
                         const int* __restrict__ lab,
                         const float* __restrict__ lse,
                         const float* __restrict__ ct, float* __restrict__ dw,
                         float* __restrict__ db, int N, int D, int V,
                         bool vec_x, bool vec_w) {
  extern __shared__ __align__(16) float smem[];
  float* xt = smem;                             // [DW_BM][XS]
  float* xr = xt + DW_BM * XS;                  // [DW_NS][DW_BM][XRS]
  float* wr = xr + DW_NS * DW_BM * XRS;         // [DW_NS][DW_KC][WS]
  float* dlb = wr + DW_NS * DW_KC * WS;         // [DW_BM][WS] dlog's big
  float* dls = dlb + DW_BM * WS;                // and small parts
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * DW_BN, d0 = blockIdx.y * DW_DC;
  // the thread's logits: rows ra, ra + 8 and columns cb + nt*8 + {0, 1}
  const int ra = (warp >> 2) * 16 + g, cb = (warp & 3) * 16 + 2 * t;
  const int m0 = warp * 32;  // the warp's rows of dW, from d0
  const bool has_dw = d0 + m0 < D;
  const bool has_db = blockIdx.y == 0 && tid < DW_BN;
  float bias[2][2];
  bool valid[2][2];
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = c0 + cb + nt * 8 + e;
      valid[nt][e] = c < V;
      bias[nt][e] = c < V ? b[c] : 0.f;
    }
  float acc[2][8][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  float db_run = 0.f;  // column c0 + tid, for has_db
  const int nk = (D + DW_KC - 1) / DW_KC, nrt = (N + DW_BM - 1) / DW_BM;
  for (int rt = 0; rt < nrt; ++rt) {
    const int r0 = rt * DW_BM;
#pragma unroll
    for (int s = 0; s < DW_NS - 1; ++s) {
      if (s < nk)
        stage_chunk(x, w, N, D, V, r0, c0, d0, s, vec_x, vec_w, xt, xr, wr);
      cp_async_commit();
    }
    int lab_r[2];
    float lse_r[2], ct_r[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = r0 + ra + 8 * h;
      lab_r[h] = r < N ? lab[r] : -1;
      lse_r[h] = r < N ? lse[r] : 0.f;
      ct_r[h] = r < N ? ct[r] : 0.f;
    }
    float lg[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) lg[nt][i] = 0.f;
    for (int j = 0; j < nk; ++j) {
      cp_async_wait<DW_NS - 2>();  // chunk j has landed (this thread's part)
      __syncthreads();             // ... everyone's; stage (j-1) % NS is free
      if (j + DW_NS - 1 < nk)
        stage_chunk(x, w, N, D, V, r0, c0, d0, j + DW_NS - 1, vec_x, vec_w,
                    xt, xr, wr);
      cp_async_commit();
      int xs;
      const float* xv = x_chunk(xt, xr, j, d0, xs);
      logits_chunk(xv, xs, wr + (j % DW_NS) * DW_KC * WS, lg);
    }
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 8 * h, c = cb + nt * 8;
        const bool row_live = r0 + r < N;
        const float v0 = dlog_value(lg[nt][2 * h], bias[nt][0], lse_r[h],
                                    ct_r[h], lab_r[h], c0 + c,
                                    valid[nt][0] && row_live);
        const float v1 = dlog_value(lg[nt][2 * h + 1], bias[nt][1],
                                    lse_r[h], ct_r[h], lab_r[h], c0 + c + 1,
                                    valid[nt][1] && row_live);
        const float b0 = __uint_as_float(tf32_bits(v0));
        const float b1 = __uint_as_float(tf32_bits(v1));
        *reinterpret_cast<float2*>(&dlb[r * WS + c]) = make_float2(b0, b1);
        *reinterpret_cast<float2*>(&dls[r * WS + c]) =
            make_float2(v0 - b0, v1 - b1);
      }
    __syncthreads();  // dlog and the whole x tile are in place
    if (has_db) {
      // big + small is dlog exactly
      float colsum = 0.f;
#pragma unroll 8
      for (int r = 0; r < DW_BM; ++r)
        colsum += dlb[r * WS + tid] + dls[r * WS + tid];
      db_run += colsum;
    }
    if (has_dw) dw_tile(xt, dlb, dls, m0, acc);
    __syncthreads();  // the x tile, the rings and dlog are free
  }
  if (has_dw) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = d0 + m0 + mt * 16 + g + (i >> 1) * 8;
          const int c = c0 + nt * 8 + 2 * t + (i & 1);
          if (d < D && c < V) dw[(size_t)d * V + c] = acc[mt][nt][i];
        }
  }
  if (has_db && c0 + tid < V) db[c0 + tid] = db_run;
}

// --- dx on the tensor cores (3xTF32 mma.sync) -------------------------------

constexpr int DX_THREADS = 256;  // 8 warps
constexpr int DX_WARPS = DX_THREADS / 32;
constexpr int DX_BM = 64;        // rows of x and dx a block
constexpr int DX_BN = 64;        // vocabulary columns a tile
constexpr int DX_DC = 512;       // columns of dx a block holds in registers
constexpr int DX_MT = DX_DC / DX_WARPS / 16;   // 16-column dx tiles a warp
constexpr int DX_LNT = DX_BM * DX_BN / DX_WARPS / 128;  // 16 x 8 logit
                                                         // tiles a warp
constexpr int DX_WN = DX_BN / (DX_LNT * 8);    // warps sharing their rows
constexpr int DX_KC = 64;        // depth of one staged step of the logits
constexpr int DX_NS = 2;         // stages of the cp.async rings
constexpr int TS = 72;           // row of every dx tile in shared memory:
                                 // w [DX_DC][TS], x stages [DX_BM][TS],
                                 // dlog^T [DX_BN][TS]; 8 mod 32
constexpr int DX_SMEM =
    (DX_DC * TS + DX_NS * DX_BM * TS + 2 * DX_BN * TS) * 4;
static_assert(DX_NS * DX_KC <= 2 * DX_BN, "the w ring lives in dlog's place");
static_assert(DX_BM == DX_KC && DX_KC == DX_BN, "64 x 64 chunks");

// a = big + small: big = a with its low 13 mantissa bits cleared (TF32,
// truncated: a mask and a subtraction in all, where cvt.rna.tf32.f32 is a
// slow conversion), small = a - big exact in float32 (the tensor cores
// read its top 10 mantissa bits, an error of the order of the dropped
// small·small term)
__device__ __forceinline__ void split_big(float a, unsigned& big,
                                          unsigned& small) {
  big = __float_as_uint(a) & 0xFFFFE000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

// start the copies of an nrows x 64 block of a row-major [rows, cols]
// matrix (rows from r0, columns from q0) into dst at a[r][q] -> r * TS +
// (q ^ (r & 4)), zero past (rows, cols); the `n` threads from `tid` share
// them. 16-byte copies where rows of `cols` floats keep them aligned (vec)
template <int n>
__device__ __forceinline__ void dx_copy(const float* __restrict__ a,
                                        int rows, int cols, int r0, int q0,
                                        bool vec, float* dst, int tid,
                                        int nrows = DX_KC) {
  if (vec) {
#pragma unroll
    for (int i = 0; i < nrows * 16 / n; ++i) {
      const int e = tid + i * n, r = e >> 4, q = (e & 15) * 4;
      const bool ok = r0 + r < rows && q0 + q < cols;
      cp_async16(dst + r * TS + (q ^ (r & 4)),
                 ok ? a + (size_t)(r0 + r) * cols + q0 + q : a, ok);
    }
  } else {
    for (int i = 0; i < nrows * 64 / n; ++i) {
      const int e = tid + i * n, r = e >> 6, q = e & 63;
      const bool ok = r0 + r < rows && q0 + q < cols;
      cp_async4(dst + r * TS + (q ^ (r & 4)),
                ok ? a + (size_t)(r0 + r) * cols + q0 + q : a, ok);
    }
  }
}

// lg += the chunk's share of the logits, the big·big pass in lg[nt][1] and
// the two small passes in lg[nt][0]: two independent chains a tile, the
// longer two thirds as long as one through all three passes. Warp (wm,
// wn) = (warp / DX_WN, warp % DX_WN) owns rows wm*16 .. +16 and columns
// wn*DX_LNT*8 .. +DX_LNT*8, DX_LNT tiles of 16 x 8; xv is the chunk's x
// stage, wv its w rows
__device__ __forceinline__ void dx_logits_chunk(const float* xv,
                                                const float* wv,
                                                float lg[DX_LNT][2][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ra = (warp / DX_WN) * 16 + g, sw = ra & 4;
  const int n = (warp % DX_WN) * DX_LNT * 8 + g;
#pragma unroll
  for (int kk = 0; kk < DX_KC; kk += 8) {
    // x columns kk + t and kk + t + 4, swizzled by the row's bit 2
    unsigned ab[4], as[4];
    split_big(xv[ra * TS + kk + t + sw], ab[0], as[0]);
    split_big(xv[(ra + 8) * TS + kk + t + sw], ab[1], as[1]);
    split_big(xv[ra * TS + kk + t + 4 - sw], ab[2], as[2]);
    split_big(xv[(ra + 8) * TS + kk + t + 4 - sw], ab[3], as[3]);
#pragma unroll
    for (int nt = 0; nt < DX_LNT; ++nt) {
      // w rows kk + t (swizzle 0) and kk + t + 4 (swizzle 4)
      unsigned bb[2], bs[2];
      split_big(wv[(kk + t) * TS + n + nt * 8], bb[0], bs[0]);
      split_big(wv[(kk + t + 4) * TS + ((n + nt * 8) ^ 4)], bb[1], bs[1]);
      mma_tf32(lg[nt][0], ab, bs);
      mma_tf32(lg[nt][0], as, bb);
      mma_tf32(lg[nt][1], ab, bb);
    }
  }
}

// acc += (dlog @ w_tile^T)^T for the warp's DX_MT*16 columns of dx (from
// m0 of the block's D chunk) and all 64 rows: DX_MT x 8 tiles of 16 x 8
// of dx^T = w_tile @ dlog^T, over the tile's 64 vocabulary columns. A = w
// read from the w tile (rows d, columns c, swizzled), B = dlog^T's two
// parts (big, and small = dlog - big). Each 8-column step's three passes
// form in fresh accumulators, added to acc in float32: the tensor cores
// truncate each MMA's float32 sum, so sums kept inside the MMAs over all
// of V would drift by up to an ulp for every 8 columns they pass
__device__ __forceinline__ void dx_tile(const float* wt, const float* dlb,
                                        const float* dls, int m0,
                                        float acc[DX_MT][8][4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int sw = g & 4;
#pragma unroll 1
  for (int kk = 0; kk < DX_BN; kk += 8) {
    unsigned ab[DX_MT][4], as[DX_MT][4];
#pragma unroll
    for (int mt = 0; mt < DX_MT; ++mt) {
      const float* w0 = wt + (m0 + mt * 16 + g) * TS + kk;
      const float* w8 = w0 + 8 * TS;
      split_big(w0[t + sw], ab[mt][0], as[mt][0]);
      split_big(w8[t + sw], ab[mt][1], as[mt][1]);
      split_big(w0[t + 4 - sw], ab[mt][2], as[mt][2]);
      split_big(w8[t + 4 - sw], ab[mt][3], as[mt][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int i0 = (kk + t) * TS + nt * 8 + g, i1 = i0 + 4 * TS;
      const unsigned bb[2] = {__float_as_uint(dlb[i0]),
                              __float_as_uint(dlb[i1])};
      const unsigned bs[2] = {__float_as_uint(dls[i0]),
                              __float_as_uint(dls[i1])};
#pragma unroll
      for (int mt = 0; mt < DX_MT; ++mt) {
        float c[4] = {0.f, 0.f, 0.f, 0.f};
        mma_3xtf32(c, ab[mt], as[mt], bb, bs);
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] += c[i];
      }
    }
  }
}

// grid (row tiles of 64, S slices, D chunks of 512): the block's dx [64,
// 512] stays in registers (64 a thread) over all column tiles of its
// slice and is written once into its slice's partial. Per column tile of
// 64: the logits over all of D in k-chunks of 64, the block's own D chunk
// first (x through a 2-stage cp.async ring; w in the w tile, whose bits
// dx's product then reads again; depths outside the chunk through a w
// ring in dlog's place), dlog^T split into shared memory, and dx_tile.
// The next tile's first two x chunks are copied during dx_tile, and each
// warp copies the next tile's w rows that it alone reads there as soon as
// it is done with them: a tile's copies wait at no barrier of their own.
// Shared memory: the w tile, the x ring and dlog, DX_SMEM bytes.
__global__ void __launch_bounds__(DX_THREADS, 1)
vocab_xent_bwd_dx_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,
                         const float* __restrict__ b,
                         const int* __restrict__ lab,
                         const float* __restrict__ lse,
                         const float* __restrict__ ct,
                         float* __restrict__ part, int N, int D, int V,
                         int S, bool vec_x, bool vec_w) {
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;                      // [DX_DC][TS]
  float* xr = wt + DX_DC * TS;           // [DX_NS][DX_BM][TS]
  float* dlb = xr + DX_NS * DX_BM * TS;  // [DX_BN][TS] dlog^T's big part
  float* dls = dlb + DX_BN * TS;         // and small part
  float* wr = dlb;                       // [DX_NS][DX_KC][TS]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * DX_BM, s = blockIdx.y, d0 = blockIdx.z * DX_DC;
  int lo, hi;
  slice_tiles((V + SLICE_COLS - 1) / SLICE_COLS, S, s, lo, hi);
  const int c_lo = lo * SLICE_COLS, c_hi = min(V, hi * SLICE_COLS);
  // the thread's logits: rows ra, ra + 8 and columns cb + nt*8 + {0, 1}
  const int ra = (warp / DX_WN) * 16 + g;
  const int cb = (warp % DX_WN) * DX_LNT * 8 + 2 * t;
  const int m0 = warp * DX_MT * 16;  // the warp's columns of dx, from d0
  const bool has_dx = d0 + m0 < D;
  // the k-chunks in the order the logits take them: the D chunk's nin
  // (from chunk q0) first, then the others in order
  const int nk = (D + DX_KC - 1) / DX_KC, q0 = d0 / DX_KC;
  const int nin = min(DX_DC / DX_KC, nk - q0);
  auto chunk = [&](int p) {
    return p < nin ? q0 + p : (p - nin < q0 ? p - nin : p);
  };
  // the copies of x chunk p (the same for every column tile; a tile's
  // first two are made during the tile before), and of the w of column
  // tile c0's chunk p where it lies outside the D chunk
  auto x_stage = [&](int p) { return xr + (p % DX_NS) * DX_BM * TS; };
  auto stage_x = [&](int p) {
    dx_copy<DX_THREADS>(x, N, D, r0, chunk(p) * DX_KC, vec_x, x_stage(p),
                        tid);
  };
  auto stage_ring = [&](int p, int c0) {
    if (p < nin) return;
    dx_copy<DX_THREADS>(w, D, V, chunk(p) * DX_KC, c0, vec_w,
                        wr + (p % DX_NS) * DX_KC * TS, tid);
  };
  // the warp's DX_MT*16 rows of the w tile
  auto stage_rows = [&](int c0) {
    dx_copy<32>(w, D, V, d0 + m0, c0, vec_w, wt + m0 * TS, lane,
                DX_MT * 16);
  };
  int lab_r[2];
  float lse_r[2], ct_r[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + ra + 8 * h;
    lab_r[h] = r < N ? lab[r] : -1;
    lse_r[h] = r < N ? lse[r] : 0.f;
    ct_r[h] = r < N ? ct[r] : 0.f;
  }
  float acc[DX_MT][8][4];
#pragma unroll
  for (int mt = 0; mt < DX_MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  if (c_lo < c_hi) {
    stage_x(0);
    if (nk > 1) stage_x(1);
    stage_rows(c_lo);
    cp_async_commit();
  }
  for (int c0 = c_lo; c0 < c_hi; c0 += DX_BN) {
    float lg[DX_LNT][2][4];
#pragma unroll
    for (int nt = 0; nt < DX_LNT; ++nt)
#pragma unroll
      for (int p = 0; p < 2; ++p)
#pragma unroll
        for (int i = 0; i < 4; ++i) lg[nt][p][i] = 0.f;
    for (int p = 0; p < nk; ++p) {
      cp_async_wait<0>();  // chunk p has landed (this thread's part)
      __syncthreads();     // ... everyone's; stage (p - 1) % NS is free
      if (p == 0) {
        if (nk > 1) stage_ring(1, c0);
      } else if (p + 1 < nk) {
        stage_x(p + 1);
        stage_ring(p + 1, c0);
      }
      cp_async_commit();
      const float* wv = p < nin ? wt + p * DX_KC * TS
                                : wr + (p % DX_NS) * DX_KC * TS;
      dx_logits_chunk(x_stage(p), wv, lg);
    }
    if (nin < nk) __syncthreads();  // the w ring's readers are done
#pragma unroll
    for (int nt = 0; nt < DX_LNT; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = cb + nt * 8 + e;
        const bool valid = c0 + c < V;
        const float bias = valid ? b[c0 + c] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ra + 8 * h, i = 2 * h + e;
          const float v = dlog_value(lg[nt][0][i] + lg[nt][1][i], bias,
                                     lse_r[h], ct_r[h], lab_r[h], c0 + c,
                                     valid && r0 + r < N);
          unsigned big, small;
          split_big(v, big, small);
          dlb[c * TS + r] = __uint_as_float(big);
          dls[c * TS + r] = __uint_as_float(small);
        }
      }
    __syncthreads();  // dlog and the whole w tile are in place; the x
                      // ring is free
    const bool next = c0 + DX_BN < c_hi;
    if (next) {
      stage_x(0);
      if (nk > 1) stage_x(1);
    }
    if (has_dx) dx_tile(wt, dlb, dls, m0, acc);
    __syncwarp();  // the warp's reads of its w rows are done
    if (next) stage_rows(c0 + DX_BN);
    cp_async_commit();
  }
  if (has_dx) {
    float* out = part + (size_t)s * N * D;
#pragma unroll
    for (int mt = 0; mt < DX_MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int d = d0 + m0 + mt * 16 + g + (i >> 1) * 8;
          const int r = r0 + nt * 8 + 2 * t + (i & 1);
          if (d < D && r < N) out[(size_t)r * D + d] = acc[mt][nt][i];
        }
  }
}

// --- the forward on the tensor cores (3xTF32 mma.sync) --------------------

constexpr int FWD_THREADS = 256;  // 8 warps: dx's layout of a 64 x 64 tile
constexpr int FWD_NS = 3;         // stages of the cp.async ring
constexpr int FWD_STAGE = (DX_BM + DX_KC) * TS;  // an x and a w chunk
constexpr int FWD_SMEM = FWD_NS * FWD_STAGE * 4;  // 110,592 bytes: two
                                                   // blocks an SM
static_assert(DX_THREADS == FWD_THREADS, "dx_logits_chunk's warp layout");

// the online (max, sumexp, gold) of one row: (m, l, g) absorbs (m2, l2, g2),
// each a state over disjoint columns (NEG, 0, 0 over none)
__device__ __forceinline__ void absorb(float& m, float& l, float& g, float m2,
                                       float l2, float g2) {
  const float mn = fmaxf(m, m2);
  l = l * expf(m - mn) + l2 * expf(m2 - mn);
  m = mn;
  g += g2;
}

// grid (row tiles of 64, S slices): the block's rows' online (max, sumexp,
// gold) over its slice's column tiles of 64, written once as the slice's
// partials [3, S, N]. The (tile, k-chunk) pairs stream in order through an
// FWD_NS-stage cp.async ring, an x chunk and a w chunk a stage, copied
// FWD_NS - 1 chunks ahead across tile ends; each tile's logits are dx's
// (dx_logits_chunk, the big·big pass and the small passes in two
// accumulators added in float32 at the tile's end). Each thread carries its
// own state over its 8 columns of each tile for its two rows; the 4 lanes
// and the DX_WN warps that share a row combine theirs at the end.
__global__ void __launch_bounds__(FWD_THREADS, 2)
vocab_xent_fwd_kernel(const float* __restrict__ x,
                      const float* __restrict__ w,
                      const float* __restrict__ b,
                      const int* __restrict__ lab, float* __restrict__ part,
                      int N, int D, int V, int S, bool vec_x, bool vec_w) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * DX_BM, s = blockIdx.y;
  int lo, hi;
  slice_tiles((V + SLICE_COLS - 1) / SLICE_COLS, S, s, lo, hi);
  const int c_lo = lo * SLICE_COLS, c_hi = min(V, hi * SLICE_COLS);
  // the thread's logits: rows ra, ra + 8 and columns cb + nt*8 + {0, 1}
  const int ra = (warp / DX_WN) * 16 + g;
  const int cb = (warp % DX_WN) * DX_LNT * 8 + 2 * t;
  const int nk = (D + DX_KC - 1) / DX_KC;
  const int total = (c_hi - c_lo + DX_BN - 1) / DX_BN * nk;
  auto stage = [&](int q) { return smem + (q % FWD_NS) * FWD_STAGE; };
  // chunk q: k-chunk q % nk of column tile q / nk
  auto copy = [&](int q) {
    const int c0 = c_lo + q / nk * DX_BN, k0 = q % nk * DX_KC;
    float* st = stage(q);
    dx_copy<FWD_THREADS>(x, N, D, r0, k0, vec_x, st, tid);
    dx_copy<FWD_THREADS>(w, D, V, k0, c0, vec_w, st + DX_BM * TS, tid);
  };
  int lab_r[2];
  float m_run[2], l_run[2], g_run[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + ra + 8 * h;
    lab_r[h] = r < N ? lab[r] : -1;
    m_run[h] = NEG;
    l_run[h] = 0.f;
    g_run[h] = 0.f;
  }
#pragma unroll
  for (int q = 0; q < FWD_NS - 1; ++q) {
    if (q < total) copy(q);
    cp_async_commit();
  }
  float lg[DX_LNT][2][4];
  float bias[DX_LNT][2];
  for (int q = 0; q < total; ++q) {
    const int p = q % nk, c0 = c_lo + q / nk * DX_BN;
    if (p == 0) {  // a new tile: its bias, fresh accumulators
#pragma unroll
      for (int nt = 0; nt < DX_LNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + cb + nt * 8 + e;
          bias[nt][e] = c < V ? b[c] : 0.f;
        }
#pragma unroll
        for (int pass = 0; pass < 2; ++pass)
#pragma unroll
          for (int i = 0; i < 4; ++i) lg[nt][pass][i] = 0.f;
      }
    }
    cp_async_wait<FWD_NS - 2>();  // chunk q has landed (this thread's part)
    __syncthreads();              // ... everyone's; stage (q-1) % NS is free
    if (q + FWD_NS - 1 < total) copy(q + FWD_NS - 1);
    cp_async_commit();
    const float* st = stage(q);
    dx_logits_chunk(st, st + DX_BM * TS, lg);
    if (p < nk - 1) continue;
    // the tile's logits are complete: columns >= V stay out of the state
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v[DX_LNT][2], mx = NEG;
#pragma unroll
      for (int nt = 0; nt < DX_LNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * h + e;
          v[nt][e] = (lg[nt][0][i] + lg[nt][1][i]) + bias[nt][e];
          if (c0 + cb + nt * 8 + e < V) mx = fmaxf(mx, v[nt][e]);
        }
      const float m_new = fmaxf(m_run[h], mx);
      float sum = 0.f;
#pragma unroll
      for (int nt = 0; nt < DX_LNT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + cb + nt * 8 + e;
          if (c >= V) continue;
          sum += expf(v[nt][e] - m_new);
          if (c == lab_r[h]) g_run[h] += v[nt][e];
        }
      l_run[h] = l_run[h] * expf(m_run[h] - m_new) + sum;
      m_run[h] = m_new;
    }
  }
  // the row's 4 lanes (t), then its DX_WN warps in order
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int o = 1; o < 4; o <<= 1)
      absorb(m_run[h], l_run[h], g_run[h],
             __shfl_xor_sync(FULL, m_run[h], o),
             __shfl_xor_sync(FULL, l_run[h], o),
             __shfl_xor_sync(FULL, g_run[h], o));
  cp_async_wait<0>();
  __syncthreads();  // the ring is free
  float* red = smem;  // [DX_WN][DX_BM][3]
  if (t == 0) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* o = red + ((warp % DX_WN) * DX_BM + ra + 8 * h) * 3;
      o[0] = m_run[h];
      o[1] = l_run[h];
      o[2] = g_run[h];
    }
  }
  __syncthreads();
  if (tid < DX_BM && r0 + tid < N) {
    float m = red[tid * 3], l = red[tid * 3 + 1], gold = red[tid * 3 + 2];
#pragma unroll
    for (int wn = 1; wn < DX_WN; ++wn) {
      const float* o = red + (wn * DX_BM + tid) * 3;
      absorb(m, l, gold, o[0], o[1], o[2]);
    }
    const int r = r0 + tid;
    part[((size_t)0 * S + s) * N + r] = m;
    part[((size_t)1 * S + s) * N + r] = l;
    part[((size_t)2 * S + s) * N + r] = gold;
  }
}

bool sizes_ok(int N, int D, int V, int S) {
  const int nvt = (V + SLICE_COLS - 1) / SLICE_COLS;
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
  cudaError_t err = cudaFuncSetAttribute(
      vocab_xent_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  // two blocks an SM need the largest shared-memory carveout
  err = cudaFuncSetAttribute(vocab_xent_fwd_kernel,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  const bool vec_x = D % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const bool vec_w = V % 4 == 0 && ((uintptr_t)w & 15) == 0;
  const dim3 grid((N + DX_BM - 1) / DX_BM, S);
  vocab_xent_fwd_kernel<<<grid, FWD_THREADS, FWD_SMEM,
                          (cudaStream_t)stream>>>(x, w, b, lab, part, N, D, V,
                                                  S, vec_x, vec_w);
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
  if (!sizes_ok(N, D, V, S) || (D + DX_DC - 1) / DX_DC > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      vocab_xent_bwd_dx_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DX_SMEM);
  if (err != cudaSuccess) return (int)err;
  const bool vec_x = D % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const bool vec_w = V % 4 == 0 && ((uintptr_t)w & 15) == 0;
  const dim3 grid((N + DX_BM - 1) / DX_BM, S, (D + DX_DC - 1) / DX_DC);
  vocab_xent_bwd_dx_kernel<<<grid, DX_THREADS, DX_SMEM,
                             (cudaStream_t)stream>>>(
      x, w, b, lab, lse, ct, part, N, D, V, S, vec_x, vec_w);
  return (int)cudaGetLastError();
}

int vocab_xent_bwd_dx_reduce(const float* part, float* dx, int N, int D,
                             int S, void* stream) {
  if (N < 1 || D < 1 || S < 1) return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)N * D;
  const bool vec = total % 4 == 0 && ((uintptr_t)part & 15) == 0 &&
                   ((uintptr_t)dx & 15) == 0;
  const size_t n = vec ? total / 4 : total;
  size_t blocks = (n + SUM_THREADS - 1) / SUM_THREADS;
  if (blocks > SUM_MAX_BLOCKS) blocks = SUM_MAX_BLOCKS;
  if (vec)
    vocab_xent_bwd_dx_reduce_kernel<float4><<<(unsigned)blocks, SUM_THREADS,
                                              0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(dx),
        n, S);
  else
    vocab_xent_bwd_dx_reduce_kernel<float><<<(unsigned)blocks, SUM_THREADS,
                                             0, (cudaStream_t)stream>>>(
        part, dx, n, S);
  return (int)cudaGetLastError();
}

int vocab_xent_bwd_dw(const float* x, const float* w, const float* b,
                      const int* lab, const float* lse, const float* ct,
                      float* dw, float* db, int N, int D, int V,
                      void* stream) {
  if (!sizes_ok(N, D, V, 1) || (D + DW_DC - 1) / DW_DC > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      vocab_xent_bwd_dw_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      DW_SMEM);
  if (err != cudaSuccess) return (int)err;
  const bool vec_x = D % 4 == 0 && ((uintptr_t)x & 15) == 0;
  const bool vec_w = V % 4 == 0 && ((uintptr_t)w & 15) == 0;
  const dim3 grid((V + DW_BN - 1) / DW_BN, (D + DW_DC - 1) / DW_DC);
  vocab_xent_bwd_dw_kernel<<<grid, DW_THREADS, DW_SMEM,
                             (cudaStream_t)stream>>>(
      x, w, b, lab, lse, ct, dw, db, N, D, V, vec_x, vec_w);
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
