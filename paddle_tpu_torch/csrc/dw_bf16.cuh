// The weight gradients' pair reduction on the bf16 tensor cores, which
// csrc/gru_bwd.cu (gru_bwd_dw_bf16) and csrc/lstm_bwd.cu
// (lstm_bwd_dw_bf16) share: the same tiles, splits and fixed order as
// csrc/dw_tf32.cuh's float32 reduction, its operands bf16. D = the
// columns of dx (dx3, dx4) as stored, A = h_prev * (1 - reset), times r
// for the GRU's dWc, formed in float32 and rounded to bf16 (jnp's astype
// before the dot) as the fragments are built; ONE mma.sync m16n8k16 pass
// with float32 accumulation computes A^T D exactly as the TPU's bf16 dot (a
// product of two bf16 values is exact in float32). Each chunk's sum forms
// in fresh accumulators and is added in float32, as dw_chunk's.
// kernels/_build.py hashes this header into the name of every library
// whose source includes it, so an edit here rebuilds them all.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "dw_tf32.cuh"
#include "hopper.cuh"

namespace {

constexpr int DWB_LD = DW_TILE + 8;         // bf16 a staged row: 144 bytes
constexpr int DWB_TILE = DW_CH * DWB_LD;    // bf16 a staged tile
// a stage: A's rows, r's rows and D's columns ([DW_CH][DWB_LD] bf16
// each), then the pairs' reset values (floats)
constexpr int DWB_STAGE_BYTES = 3 * DWB_TILE * 2 + DW_CH * 4;
constexpr int DWB_SMEM = DW_NS * DWB_STAGE_BYTES;
constexpr int DWB_COPIES = DW_CH * DW_TILE / 8 / DW_THREADS;  // 16-byte
static_assert(DWB_COPIES == 2, "a thread copies 2 rows of 8 bf16");
static_assert(DWB_STAGE_BYTES % 16 == 0, "stages 16-byte aligned");

__device__ __forceinline__ void mma_bf16(float c[4], const unsigned a[4],
                                         const unsigned b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two floats rounded to bf16 (to nearest even), lo in the low half
__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// two staged bf16 as they are, lo in the low half
__device__ __forceinline__ unsigned pair_bf16(const bf16* lo,
                                              const bf16* hi) {
  return (unsigned)*reinterpret_cast<const unsigned short*>(lo) |
         ((unsigned)*reinterpret_cast<const unsigned short*>(hi) << 16);
}

// Start the copies of chunk c (pairs n = c*DW_CH + row) into stage `st`,
// bf16 rows of 8 values a copy: the rows of h_prev, hs row n - 1 (hs [N][H]),
// zero-filled at a row's first step (n % T == 0) and past N; with CAND the
// GRU's r under them (its stash [N][3H], columns H..2H); D's columns from
// `dcol` (D [N][dld], `jok` where the thread's 8 lie inside its width);
// reset[n]. Thread tid copies columns 8 * (tid % 8) of rows tid / 8 + 16i,
// whose n % T it keeps in tq[i], advanced here to the next chunk.
template <bool CAND, bool RESET>
__device__ __forceinline__ void dwb_stage(
    const float* __restrict__ reset, const bf16* __restrict__ gates,
    const bf16* __restrict__ hs, const bf16* __restrict__ dx, char* st,
    unsigned c, unsigned N, int T, int H, int k0, int dcol, int dld,
    bool kok, bool jok, int tq[DWB_COPIES]) {
  const int tid = threadIdx.x, q = (tid & 7) * 8;
  bf16* hsm = reinterpret_cast<bf16*>(st);
  bf16* rsm = hsm + DWB_TILE;
  bf16* dsm = rsm + DWB_TILE;
#pragma unroll
  for (int i = 0; i < DWB_COPIES; ++i) {
    const int row = (tid >> 3) + 16 * i;
    const unsigned n = c * DW_CH + row;
    const bool live = n < N;
    const bool hk = live && kok && tq[i] != 0;
    cp_async16(reinterpret_cast<float*>(hsm + row * DWB_LD + q),
               reinterpret_cast<const float*>(
                   hs + (hk ? (size_t)(n - 1) * H + k0 + q : 0)),
               hk);
    if (CAND)
      cp_async16(reinterpret_cast<float*>(rsm + row * DWB_LD + q),
                 reinterpret_cast<const float*>(
                     gates + (hk ? (size_t)n * 3 * H + H + k0 + q : 0)),
                 hk);
    const bool dk = live && jok;
    cp_async16(reinterpret_cast<float*>(dsm + row * DWB_LD + q),
               reinterpret_cast<const float*>(
                   dx + (dk ? (size_t)n * dld + dcol + q : 0)),
               dk);
    tq[i] += DW_CH;
    while (tq[i] >= T) tq[i] -= T;
  }
  if (RESET && tid < DW_CH) {
    const unsigned n = c * DW_CH + tid;
    cp_async4(reinterpret_cast<float*>(dsm + DWB_TILE) + tid,
              reset + (n < N ? n : 0), n < N);
  }
}

// acc += the staged chunk's A^T D for the warp's 32 x 32 quarter: 2 x 4
// tiles of 16 x 8, two depth steps of 16 pairs. Fragments (g = lane / 4, t
// = lane % 4): A^T rows k = m0 + g (+ 8), pairs 2t, 2t+1 (+ 8); D pairs
// 2t, 2t+1 (+ 8), column n0 + g. The chunk's sum forms in fresh
// accumulators and is added to acc in float32, as dw_chunk's
template <bool CAND, bool RESET>
__device__ __forceinline__ void dwb_chunk(const char* st,
                                          float acc[2][4][4]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int m0 = (warp >> 1) * 32 + g, n0 = (warp & 1) * 32 + g;
  const bf16* hsm = reinterpret_cast<const bf16*>(st);
  const bf16* rsm = hsm + DWB_TILE;
  const bf16* dsm = rsm + DWB_TILE;
  const float* psm = reinterpret_cast<const float*>(dsm + DWB_TILE);
  float part[2][4][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) part[mt][nt][i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < DW_CH; kk += 16) {
    // the lane's four pairs: 2t, 2t+1, 2t+8, 2t+9 of the depth step
    const int p[4] = {kk + 2 * t, kk + 2 * t + 1, kk + 2 * t + 8,
                      kk + 2 * t + 9};
    float f[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) f[e] = RESET ? 1.f - psm[p[e]] : 1.f;
    unsigned a[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      const int m = m0 + mt * 16;
      float v[2][4];  // [row m, m + 8][pair e]
#pragma unroll
      for (int e = 0; e < 4; ++e)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int at = p[e] * DWB_LD + m + 8 * h;
          float x = __bfloat162float(hsm[at]);
          if (RESET) x *= f[e];
          if (CAND) x = __bfloat162float(rsm[at]) * x;
          v[h][e] = x;
        }
      a[mt][0] = pack_bf16(v[0][0], v[0][1]);
      a[mt][1] = pack_bf16(v[1][0], v[1][1]);
      a[mt][2] = pack_bf16(v[0][2], v[0][3]);
      a[mt][3] = pack_bf16(v[1][2], v[1][3]);
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + nt * 8;
      const unsigned b[2] = {
          pair_bf16(dsm + p[0] * DWB_LD + n, dsm + p[1] * DWB_LD + n),
          pair_bf16(dsm + p[2] * DWB_LD + n, dsm + p[3] * DWB_LD + n)};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) mma_bf16(part[mt][nt], a[mt], b);
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] += part[mt][nt][i];
}


}  // namespace
