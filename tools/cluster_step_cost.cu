// What one step of a cluster recurrence costs on the card, apart from its
// arithmetic: a loop of `iters` steps in every block of `clusters`
// clusters of C blocks (256 threads each), each step
//   mode 0: cluster.sync() alone;
//   mode 1: the block's run of n floats copied into the cluster's other
//           C - 1 blocks' shared memory, 16 bytes a store
//           (map_shared_rank), then cluster.sync(): the exchange of
//           csrc/gru_fwd.cu's cluster kernel;
//   mode 2: __syncthreads() alone;
//   mode 3: mode 1 with one 4-byte store a thread to device memory just
//           before the barrier (a recurrence's hs and stash stores).
// Built by tools/torch_cluster_step_cost.py, which times it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;

template <int MODE>
__global__ void __launch_bounds__(THREADS, 1)
step_cost_kernel(float* out, float* sink, int iters, int n) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) float buf[];  // [C][n]
  const int C = gridDim.x, rank = blockIdx.x, n4 = n / 4;
  for (int i = threadIdx.x; i < C * n; i += THREADS) buf[i] = (float)i;
  cluster.sync();
  for (int it = 0; it < iters; ++it) {
    if (MODE == 1 || MODE == 3) {
      for (int i = threadIdx.x; i < (C - 1) * n4; i += THREADS) {
        const int j = (rank + 1 + i / n4) % C, e = rank * n + 4 * (i % n4);
        float4 v = *reinterpret_cast<const float4*>(buf + e);
        v.x += 1.f;
        *reinterpret_cast<float4*>(cluster.map_shared_rank(buf + e, j)) = v;
      }
    }
    if (MODE == 3)
      sink[((size_t)(blockIdx.y * C + rank) * iters + it) * THREADS +
           threadIdx.x] = buf[threadIdx.x % n];
    if (MODE == 2)
      __syncthreads();
    else
      cluster.sync();
  }
  if (threadIdx.x == 0)
    out[blockIdx.y * C + rank] = buf[((rank + 1) % C) * n];
}

template <int MODE>
cudaError_t launch(float* out, float* sink, int C, int clusters, int iters,
                   int n, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (size_t)C * n;
  cudaError_t err = cudaFuncSetAttribute(
      step_cost_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  if (C > 8) {
    err = cudaFuncSetAttribute(step_cost_kernel<MODE>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, clusters);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, step_cost_kernel<MODE>, out, sink, iters,
                           n);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// `sink` holds clusters * C * iters * 256 floats (mode 3's stores)
extern "C" int cluster_step_cost(float* out, float* sink, int mode, int C,
                                 int clusters, int iters, int n,
                                 void* stream) {
  if (C < 1 || C > 16 || n % 4 != 0 || n < 4)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return (int)launch<0>(out, sink, C, clusters, iters, n, st);
    case 1:
      return (int)launch<1>(out, sink, C, clusters, iters, n, st);
    case 2:
      return (int)launch<2>(out, sink, C, clusters, iters, n, st);
    case 3:
      return (int)launch<3>(out, sink, C, clusters, iters, n, st);
  }
  return (int)cudaErrorInvalidValue;
}
