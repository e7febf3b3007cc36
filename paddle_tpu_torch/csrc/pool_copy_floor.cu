// The copy floor of the max-pool backward on the card: a kernel that
// reads x and dy once and writes dx once, in 16-byte vectors, and does
// nothing else (dx = x, plus dy over dy's first float4s, so no load is
// dead). Its time is the card's achievable rate for the bytes that
// pool.cu's maxpool_bwd must move. A yardstick, on no path of the port:
// built beside the kernels and timed by chip_smoke.py's pool phase and
// tools/torch_pool_bwd_levers.py.
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // float4s a thread, all loaded before any store

__global__ void __launch_bounds__(THREADS)
copy_floor_kernel(const float4* __restrict__ x, const float4* __restrict__ dy,
                  float4* __restrict__ dx, size_t n4, size_t ndy4) {
  const size_t base = (size_t)blockIdx.x * THREADS * UNROLL + threadIdx.x;
  float4 v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const size_t i = base + (size_t)u * THREADS;
    if (i < n4) v[u] = x[i];
    if (i < ndy4) {
      const float4 g = dy[i];
      v[u].x += g.x;
      v[u].y += g.y;
      v[u].z += g.z;
      v[u].w += g.w;
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const size_t i = base + (size_t)u * THREADS;
    if (i < n4) dx[i] = v[u];
  }
}

}  // namespace

extern "C" {

// x and dx of n floats, dy of ndy floats (multiples of 4, 16-byte
// aligned, ndy <= n); return the cudaError_t of the launch.
int pool_copy_floor(const float* x, const float* dy, float* dx, long long n,
                    long long ndy, void* stream) {
  if (n % 4 || ndy % 4 || ndy > n) return (int)cudaErrorInvalidValue;
  const size_t n4 = (size_t)n / 4, per_block = (size_t)THREADS * UNROLL;
  copy_floor_kernel<<<(unsigned)((n4 + per_block - 1) / per_block), THREADS,
                      0, (cudaStream_t)stream>>>(
      reinterpret_cast<const float4*>(x), reinterpret_cast<const float4*>(dy),
      reinterpret_cast<float4*>(dx), n4, (size_t)ndy / 4);
  return (int)cudaGetLastError();
}

}  // extern "C"
