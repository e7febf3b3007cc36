// Rate and latency of mma.sync.m16n8k8 with TF32 operands on the card: each
// warp issues `iters` rounds of CHAINS independent MMAs (one accumulator
// each) on fragments read from memory, with no other work. Built and timed
// by tools/torch_mma_tf32_rate.py.
#include <cuda_runtime.h>

template <int CHAINS>
__global__ void mma_rate_kernel(const unsigned* __restrict__ in,
                                float* __restrict__ out, int iters) {
  const int lane = threadIdx.x & 31;
  unsigned a[4], b[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = in[(lane * 6 + i) & 255];
  b[0] = in[(lane * 6 + 4) & 255];
  b[1] = in[(lane * 6 + 5) & 255];
  float c[CHAINS][4];
#pragma unroll
  for (int k = 0; k < CHAINS; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[k][i] = 0.f;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int k = 0; k < CHAINS; ++k)
      asm volatile(
          "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
          "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
          : "+f"(c[k][0]), "+f"(c[k][1]), "+f"(c[k][2]), "+f"(c[k][3])
          : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]),
            "r"(b[1]));
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < CHAINS; ++k) s += c[k][0] + c[k][1] + c[k][2] + c[k][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}

extern "C" int mma_tf32_rate(const unsigned* in, float* out, int blocks,
                             int threads, int chains, int iters,
                             void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (chains == 1)
    mma_rate_kernel<1><<<blocks, threads, 0, st>>>(in, out, iters);
  else if (chains == 8)
    mma_rate_kernel<8><<<blocks, threads, 0, st>>>(in, out, iters);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}
