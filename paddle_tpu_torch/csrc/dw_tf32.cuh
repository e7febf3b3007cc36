// The weight gradients' pair reduction on the tensor cores, which
// csrc/gru_bwd.cu (gru_bwd_dw) and csrc/lstm_bwd.cu (lstm_bwd_dw) share:
// dW = A^T D summed over the B*T (row, step) pairs, as mma.sync m16n8k8
// with TF32 operands in three passes. Each operand is split a = big +
// small, big its top 10 mantissa bits and small the rest; big·small +
// small·big + big·big keep float32's accuracy (csrc/vocab_xent.cu's dW and
// dx do the same with their own copies). A block of 4 warps owns a 64 x 64
// output tile (rows k, columns j), a 32 x 32 quarter a warp, and walks its
// pairs in chunks of DW_CH through DW_NS cp.async stages; each stage holds
// the chunk's A rows, a second tile of DW_CH rows (the GRU's r, the LSTM's
// cell states), D's columns and the pairs' reset values. Also here: the sum
// of a split reduction's partials, in split order. kernels/_build.py
// hashes this header into the name of every library whose source includes
// it, so an edit here rebuilds them all.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int DW_TILE = 64;          // output tile: 64 rows k x 64 columns j
constexpr int DW_THREADS = 128;      // 4 warps, each a 32 x 32 quarter
constexpr int DW_CH = 32;            // (row, step) pairs a staged chunk
constexpr int DW_NS = 2;             // stages of the cp.async ring
constexpr int DW_LD = DW_TILE + 8;   // row of a staged tile: 8 mod 32
constexpr int DW_TILE_F = DW_CH * DW_LD;
// a stage: A's rows, the second tile and D's columns of the chunk's pairs
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

// acc += the staged chunk's A^T D for the warp's 32 x 32 quarter of the
// tile (rows k, columns j): 2 x 4 tiles of 16 x 8, four depth steps of 8
// pairs. A = the staged rows times (1 - reset) with RESET, times the second
// tile with CAND, formed in float32 as the fragments are read; D = the
// staged columns. The chunk's sum forms in fresh accumulators and is added
// to acc in float32: the tensor cores truncate each MMA's float32 sum, so
// sums kept inside the MMAs over thousands of pairs would drift by up to an
// ulp for every 8 pairs
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
dw_reduce_kernel(const V* __restrict__ part, V* __restrict__ out,
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

// Sums S partials [S][total] into out [total] in split order on `stream`;
// returns the cudaError_t of the launch
cudaError_t dw_reduce(const float* part, float* out, int total, int S,
                      cudaStream_t stream) {
  if (total < 1 || S < 1) return cudaErrorInvalidValue;
  const bool vec = total % 4 == 0 && ((uintptr_t)part & 15) == 0 &&
                   ((uintptr_t)out & 15) == 0;
  const size_t n = vec ? total / 4 : total;
  size_t blocks = (n + SUM_THREADS - 1) / SUM_THREADS;
  if (blocks > SUM_MAX_BLOCKS) blocks = SUM_MAX_BLOCKS;
  if (vec)
    dw_reduce_kernel<float4><<<(unsigned)blocks, SUM_THREADS, 0, stream>>>(
        reinterpret_cast<const float4*>(part), reinterpret_cast<float4*>(out),
        n, S);
  else
    dw_reduce_kernel<float><<<(unsigned)blocks, SUM_THREADS, 0, stream>>>(
        part, out, n, S);
  return cudaGetLastError();
}

}  // namespace
