// Fused P1 plane-stress element energy and its cotangents, for Hopper.
//
// Replaces the TPU kernels of hidenn_fem_tpu/ops/pallas_energy.py:
//   K1  _forward  (pallas_call at pallas_energy.py:154): the energy sum
//   K2  _bwd_rule (pallas_call at pallas_energy.py:178): d(energy)/d(corners)
// Per element, the triangle energy E_elem = w_sum |det| dens and its
// cotangents of p1_triangle.cuh (shared with the lattice kernels),
// and, for elements e >= edge_start (Neumann edges appended as (n0, n1, n1)
// pseudo-elements), the traction term tw * ds * (u0x + u1x) / 2 with
// ds = sqrt(max(|v0 - v1|^2, 1e-30)).
//
// What bounds it on the H100: bytes, not arithmetic.  Per element the
// forward reads 12 B of connectivity and three 16 B node rows (60 B, the
// rows mostly from L2 since neighbouring elements share nodes) for ~60
// flops; the backward reads the same and writes 48 B of cotangents.  The
// design therefore fuses the connectivity gather into the kernel (the TPU
// path materialised a [12, Ne] gathered copy in HBM first), loads each
// node row as one float4, and keeps every intermediate in registers.  The
// gradient is derived by hand (the TPU kernel ran jax.grad inside its
// body) and recomputes the forward algebra instead of storing it.
//
// Node gradients.  The TPU path assembled the corner cotangents into node
// gradients with an XLA gather over a node -> corner incidence table
// (hidenn_fem_tpu/ops/assembly.py:107-114).  On the H100 the same gather
// in plain torch (index_select + sum) took 1.1 ms per call at 852,676
// elements, 88% of the energy's value-and-grad device time (torch.profiler
// on the card), so it is a kernel here too: one thread per node sums the
// float4 cotangent rows its incidence slots name, in slot order.
//
// Determinism: the forward writes one partial sum per block, reduced in a
// fixed tree order, and a second one-block kernel sums the partials in
// double in a fixed order; the node gradient sums each node's slots in a
// fixed order.  No atomics anywhere.
//
// Conventions kept from the JAX package: those of p1_triangle.cuh (|det|'
// = +1 at 0, det without FMA contraction), and d max(x, c)/dx = 1/2 at a
// tie in the edge length.
//
// Built by hidenn_fem_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc
// and bound through the plain C interface at the end of this file.

#include <cuda_runtime.h>

#include "p1_triangle.cuh"

namespace {

using hdnn::Corners;
using hdnn::Material;
using hdnn::Strain;
using hdnn::block_sum;
using hdnn::corner_cotangents;
using hdnn::kSumThreads;
using hdnn::material;
using hdnn::strain;
using hdnn::sum_partials_kernel;
using hdnn::tri_energy;

constexpr int kThreads = 256;
constexpr float kDsFloor = 1e-30f;

__device__ __forceinline__ Corners load_corners(
    const float4* __restrict__ node, const int* __restrict__ conn,
    long long e) {
  const int n0 = __ldg(conn + 3 * e);
  const int n1 = __ldg(conn + 3 * e + 1);
  const int n2 = __ldg(conn + 3 * e + 2);
  return {__ldg(node + n0), __ldg(node + n1), __ldg(node + n2)};
}

__device__ __forceinline__ float edge_len(const Corners& c, float* sx,
                                          float* sy, float* s2) {
  *sx = c.v0.x - c.v1.x;
  *sy = c.v0.y - c.v1.y;
  *s2 = *sx * *sx + *sy * *sy;
  return sqrtf(fmaxf(*s2, kDsFloor));
}

// K1: one thread per element; one partial energy per block.
__global__ void __launch_bounds__(kThreads)
energy_fwd_kernel(const float4* __restrict__ node,
                  const int* __restrict__ conn, long long ne,
                  long long edge_start, Material m, float tw,
                  float* __restrict__ partials) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  if (e < ne) {
    const Corners c = load_corners(node, conn, e);
    const Strain s = strain(c, m);
    acc = tri_energy(s, m);
    if (e >= edge_start) {
      float sx, sy, s2;
      const float ds = edge_len(c, &sx, &sy, &s2);
      acc += tw * (ds * 0.5f * (c.v0.z + c.v1.z));
    }
  }
  const float total = block_sum<float, kThreads / 32>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// K2: one thread per element; writes the 12 corner cotangents times the
// upstream scalar *ct.
__global__ void __launch_bounds__(kThreads)
energy_bwd_kernel(const float4* __restrict__ node,
                  const int* __restrict__ conn, long long ne,
                  long long edge_start, Material m, float tw,
                  const float* __restrict__ ct, float4* __restrict__ cot) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= ne) return;
  const Corners c = load_corners(node, conn, e);
  const Strain s = strain(c, m);

  float4 c0, c1;
  corner_cotangents(s, m, &c0, &c1);
  // vertex 2 enters the elastic term only through a, b, d0 and d1 (and
  // not the edge term): minus their sums
  const float4 v2 = make_float4(-(c0.x + c1.x), -(c0.y + c1.y),
                                -(c0.z + c1.z), -(c0.w + c1.w));
  if (e >= edge_start) {
    float sx, sy, s2;
    const float ds = edge_len(c, &sx, &sy, &s2);
    const float gds = tw * (0.5f * (c.v0.z + c.v1.z));
    const float gate = s2 > kDsFloor ? 1.f : (s2 == kDsFloor ? 0.5f : 0.f);
    const float gs2 = gds * (0.5f / ds) * gate;
    const float gsx = gs2 * 2.f * sx;
    const float gsy = gs2 * 2.f * sy;
    const float gu = tw * (ds * 0.5f);
    c0.x += gsx;
    c0.y += gsy;
    c0.z += gu;
    c1.x -= gsx;
    c1.y -= gsy;
    c1.z += gu;
  }
  const float k = __ldg(ct);
  cot[3 * e] = make_float4(c0.x * k, c0.y * k, c0.z * k, c0.w * k);
  cot[3 * e + 1] = make_float4(c1.x * k, c1.y * k, c1.z * k, c1.w * k);
  cot[3 * e + 2] = make_float4(v2.x * k, v2.y * k, v2.z * k, v2.w * k);
}

// grad[n] = sum over k of cot[inc[n, k]], skipping slots of -1.
__global__ void __launch_bounds__(kThreads)
incidence_sum_kernel(const float4* __restrict__ cot,
                     const int* __restrict__ inc, long long n_nodes,
                     int degree, float4* __restrict__ grad) {
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= n_nodes) return;
  const int* row = inc + n * degree;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int k = 0; k < degree; ++k) {
    const int r = __ldg(row + k);
    if (r >= 0) {
      const float4 c = __ldg(cot + r);
      acc.x += c.x;
      acc.y += c.y;
      acc.z += c.z;
      acc.w += c.w;
    }
  }
  grad[n] = acc;
}

}  // namespace

extern "C" {

int hdnn_threads_per_block() { return kThreads; }

// Energy of elements [0, ne) into *out (device float); partials must hold
// ceil(ne / kThreads) floats.  Returns cudaGetLastError() after the
// launches.
int hdnn_element_energy_fwd(int device, const void* node, const void* conn,
                            long long ne, long long edge_start, float f,
                            float nu, float shear, float w_sum, float tw,
                            void* partials, int n_partials, void* out,
                            void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  energy_fwd_kernel<<<n_partials, kThreads, 0, st>>>(
      (const float4*)node, (const int*)conn, ne, edge_start,
      material(f, nu, shear, w_sum), tw, (float*)partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, kSumThreads, 0, st>>>((const float*)partials,
                                                n_partials, (float*)out);
  return (int)cudaGetLastError();
}

// Corner cotangents [ne, 3, 4] (as float4 rows) times *ct (device float).
int hdnn_element_energy_bwd(int device, const void* node, const void* conn,
                            long long ne, long long edge_start, float f,
                            float nu, float shear, float w_sum, float tw,
                            const void* ct, void* cot, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((ne + kThreads - 1) / kThreads);
  energy_bwd_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)node, (const int*)conn, ne, edge_start,
      material(f, nu, shear, w_sum), tw, (const float*)ct, (float4*)cot);
  return (int)cudaGetLastError();
}

// Node gradients [n_nodes, 4] from corner cotangent rows (float4) through
// the incidence table [n_nodes, degree] (int32, -1 padded).
int hdnn_incidence_sum(int device, const void* cot, const void* inc,
                       long long n_nodes, int degree, void* grad,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const unsigned blocks = (unsigned)((n_nodes + kThreads - 1) / kThreads);
  incidence_sum_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)cot, (const int*)inc, n_nodes, degree, (float4*)grad);
  return (int)cudaGetLastError();
}

const char* hdnn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
