// Device helpers that csrc/gru_fwd.cu, csrc/gru_bwd.cu and csrc/lstm_bwd.cu
// share: cp.async copies into shared memory, the cluster barrier in two
// halves, and the copy of a block's slice of a row state into the other
// blocks of its cluster (distributed shared memory). kernels/_build.py hashes this header
// into the name of every library whose source includes it, so an edit here
// rebuilds them all.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes global -> shared without a register round trip, cached in L2
// only (.cg): a recurrence's source may have been written by another block
// during its launch. With `ok` false it reads nothing and fills the
// destination with zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

// cp.async of 4 bytes, zero-filled where `ok` is false
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

// this thread's copies of all but the n most recent groups have landed
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(n) : "memory");
}

// a cluster barrier in two halves: arrive (release: this thread's earlier
// stores, to shared memory of any block of the cluster and to device
// memory, are visible to the cluster once all have arrived) and wait
// (acquire). Work between the two overlaps the barrier's latency
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the block's slice of a row state in its own shared memory, floats [off,
// off + n), copied into the same place in the cluster's other blocks, 16
// bytes a store (n a multiple of 4, off of 4); NT threads a block
template <int NT>
__device__ __forceinline__ void share_slice(
    cooperative_groups::cluster_group& cluster, float* buf, int off, int n) {
  const int C = gridDim.x, rank = blockIdx.x;
  for (int e = off + 4 * threadIdx.x; e < off + n; e += 4 * NT) {
    const float4 v = *reinterpret_cast<const float4*>(buf + e);
    for (int j = rank + 1; j < rank + C; ++j)
      *reinterpret_cast<float4*>(cluster.map_shared_rank(
          buf + e, j < C ? j : j - C)) = v;
  }
}

// acc[r] += hk[r] * w for the R rows of one k (hk 16-byte aligned where R
// is a multiple of 4)
template <int R>
__device__ __forceinline__ void rows_fma(float (&acc)[R], const float* hk,
                                         float w) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int r4 = 0; r4 < R / 4; ++r4) {
      const float4 h = reinterpret_cast<const float4*>(hk)[r4];
      acc[4 * r4] = fmaf(h.x, w, acc[4 * r4]);
      acc[4 * r4 + 1] = fmaf(h.y, w, acc[4 * r4 + 1]);
      acc[4 * r4 + 2] = fmaf(h.z, w, acc[4 * r4 + 2]);
      acc[4 * r4 + 3] = fmaf(h.w, w, acc[4 * r4 + 3]);
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(hk[r], w, acc[r]);
  }
}

}  // namespace
