// Windowed-gather probe K8: the sum of squares of the gathered corner rows
// of every element, each row read through a node window chosen per
// sub-block, for Hopper.
//
// Replaces the TPU kernel tools/microbench_gather.py:pallas_masked_sq
// (pallas_call at microbench_gather.py:177).  Sub-block i of eb
// consecutive elements reads rows wblk[i]*wp + rel[i, v, j] (rel < 2*wp)
// of the zero-padded node table [npad, 4]: on the TPU two wp-row windows
// were DMA'd per grid step by a scalar-prefetched block index and the
// gather was a one-hot select-and-reduce in VMEM.  Here one thread takes
// one element (j of sub-block i), reads its three float4 rows straight
// from the table (the window bounds only where the rows lie, which keeps
// them close in L2), and adds the squares of their 12 numbers.
//
// It is a measurement probe, not the solve: it asks whether a windowed
// index table earns anything on the H100 against one flat gather of the
// same rows (chip_smoke.py times both).  Bounded by bytes: 12 B of
// indices and three 16 B rows (mostly L2 hits) per element for 24 flops.
//
// Determinism: per-block partials reduced in a fixed tree order, then a
// one-block double sum in a fixed order (p1_triangle.cuh).  No atomics.
//
// Built by hidenn_fem_tpu_torch/ops/cuda_build.py (nvcc for sm_90a) and
// bound through the plain C interface at the end of this file.

#include <cuda_runtime.h>

#include "p1_triangle.cuh"

namespace {

using hdnn::block_sum;
using hdnn::kSumThreads;
using hdnn::sum_partials_kernel;

constexpr int kThreads = 256;

__device__ __forceinline__ float sq4(const float4& a) {
  return a.x * a.x + a.y * a.y + a.z * a.z + a.w * a.w;
}

// relT [S, 3, eb] int32, wblk [S] int32; one thread per element.
__global__ void __launch_bounds__(kThreads)
window_sq_kernel(const float4* __restrict__ node_pad,
                 const int* __restrict__ relT, const int* __restrict__ wblk,
                 long long n_elems, int eb, int wp,
                 float* __restrict__ partials) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  if (t < n_elems) {
    const long long i = t / eb;
    const long long j = t - i * eb;
    const long long base = (long long)__ldg(wblk + i) * wp;
    const int* r = relT + i * 3 * eb + j;
#pragma unroll
    for (int v = 0; v < 3; ++v)
      acc += sq4(__ldg(node_pad + base + __ldg(r + v * eb)));
  }
  const float total = block_sum<float, kThreads / 32>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

}  // namespace

extern "C" {

int hdnn_window_threads_per_block() { return kThreads; }

// Sum of squares over n_sub sub-blocks of eb elements into *out (device
// float); partials must hold ceil(n_sub * eb / kThreads) floats.
int hdnn_window_sq(int device, const void* node_pad, const void* relT,
                   const void* wblk, long long n_sub, int eb, int wp,
                   void* partials, int n_partials, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  window_sq_kernel<<<n_partials, kThreads, 0, st>>>(
      (const float4*)node_pad, (const int*)relT, (const int*)wblk,
      n_sub * eb, eb, wp, (float*)partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, kSumThreads, 0, st>>>((const float*)partials,
                                                n_partials, (float*)out);
  return (int)cudaGetLastError();
}

const char* hdnn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
