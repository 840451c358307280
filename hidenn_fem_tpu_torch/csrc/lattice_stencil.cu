// Lattice stencil energy and its node gradient, for Hopper.
//
// Replaces the TPU kernels of hidenn_fem_tpu/ops/lattice_slab.py:
//   K6  _pallas_vg  (pallas_call at lattice_slab.py:346): the energy and
//       the full node gradient in one pass
//   K7  _pallas_fwd (pallas_call at lattice_slab.py:365): the energy
// The mesh is an nx-by-ny node lattice (node (i, j) is row i*ny + j of the
// [N, 4] table (cx, cy, ux, uy)); quad (i, j), i < nx-1, j < ny-1, has the
// corners n00 = (i, j), n10 = (i+1, j), n11 = (i+1, j+1), n01 = (i, j+1) and
// splits into two triangles, as in hidenn_fem_tpu/ops/lattice_energy.py:
//   "up" diagonal (n00-n11):   T1 = (n00, n10, n11), T2 = (n00, n11, n01)
//   "down" diagonal (n10-n01): T1 = (n00, n10, n01), T2 = (n10, n11, n01)
// The energy is sum over quads of t1 E(T1) + t2 E(T2), E the triangle
// energy of p1_triangle.cuh.  The diagonal is a template parameter: all up,
// all down, a per-quad sel mask (> 0: up), or the zigzag parity
// (i + j + phase) even: up, computed here instead of stored.  The presence
// weights t1, t2 are per-quad masks, or 1 everywhere (a template flag).
// An absent triangle (weight 0) is skipped: it adds exactly 0 to the
// energy and to every gradient, as the JAX package's t * e does for the
// finite e that the det guard ensures.
//
// What bounds it on the H100: arithmetic and latency, not bytes.  The
// node table is 16 B a node (7.4 MB at 462,241 nodes, inside the 50 MB
// L2); K7 reads it about once and K6 reads it and writes the 16 B
// gradient, ~15 MB in all, against ~100 flops per triangle evaluation.
// The TPU kernels packed the table into a channel-major [4, R, ceil128(ny)]
// slab, cut it into 8-row-aligned windows with halo rows and double-
// buffered their DMA; those were lane and VMEM layouts.  Here each thread
// reads its corners as float4 rows straight from the node table (threads
// of a warp on neighbouring j, so the loads coalesce), and no padded row
// or column exists, so nothing needs the TPU kernel's wrap masks.
//
// K6 is one thread per node.  It visits the (up to four) quads that hold
// the node and adds, in a fixed order, the cotangent of that corner for
// each present triangle that has the node as a vertex: a gather, not a
// scatter, so it needs no atomics and gives the same bits on every run.
// A triangle is evaluated once for each of its three corners (the TPU
// kernel recomputed halo rows instead).  The TPU kernel got its gradient
// from jax.grad inside the kernel; here it is the hand-derived cotangent
// of p1_triangle.cuh, and it is written straight into node layout.
//
// Energy: thread (i, j) of either kernel adds the energy of quad (i, j)
// (if it exists) to a per-block partial, and the one-block kernel of
// p1_triangle.cuh sums the partials in double in a fixed order.  K6 and
// K7 use the same threads and blocks, so they give the same energy bits.
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
using hdnn::block_sum;
using hdnn::corner_cotangents;
using hdnn::kSumThreads;
using hdnn::material;
using hdnn::strain;
using hdnn::sum_partials_kernel;
using hdnn::tri_energy;

constexpr int kThreads = 256;

// how each quad picks its diagonal
enum Diag : int { kUp = 0, kDown = 1, kSelMask = 2, kParity = 3 };
// the corner a node occupies in a quad
enum Role : int { kR00 = 0, kR10 = 1, kR11 = 2, kR01 = 3 };

struct Lattice {
  const float4* node;  // [nx * ny] rows (cx, cy, ux, uy)
  int nx, ny;
  const float* sel;    // [nx-1, ny-1], read for kSelMask only
  const float* t1;     // [nx-1, ny-1] presence weights (masked kernels)
  const float* t2;
  int phase;           // kParity: quad (i, j) is up iff i + j + phase even
};

struct Quad {
  float4 n00, n10, n11, n01;
  bool up;
  float t1, t2;
};

template <int kDiag, bool kMasked>
__device__ __forceinline__ Quad load_quad(const Lattice& L, int i, int j) {
  const long long b = (long long)i * L.ny + j;
  const long long q = (long long)i * (L.ny - 1) + j;
  Quad Q;
  Q.n00 = __ldg(L.node + b);
  Q.n01 = __ldg(L.node + b + 1);
  Q.n10 = __ldg(L.node + b + L.ny);
  Q.n11 = __ldg(L.node + b + L.ny + 1);
  if (kDiag == kUp) Q.up = true;
  else if (kDiag == kDown) Q.up = false;
  else if (kDiag == kSelMask) Q.up = __ldg(L.sel + q) > 0.f;
  else Q.up = ((i + j + L.phase) & 1) == 0;
  Q.t1 = kMasked ? __ldg(L.t1 + q) : 1.f;
  Q.t2 = kMasked ? __ldg(L.t2 + q) : 1.f;
  return Q;
}

__device__ __forceinline__ Corners tri1(const Quad& Q) {
  return Q.up ? Corners{Q.n00, Q.n10, Q.n11} : Corners{Q.n00, Q.n10, Q.n01};
}

__device__ __forceinline__ Corners tri2(const Quad& Q) {
  return Q.up ? Corners{Q.n00, Q.n11, Q.n01} : Corners{Q.n10, Q.n11, Q.n01};
}

__device__ __forceinline__ float quad_energy(const Quad& Q,
                                             const Material& m) {
  float e = 0.f;
  if (Q.t1 != 0.f) e += Q.t1 * tri_energy(strain(tri1(Q), m), m);
  if (Q.t2 != 0.f) e += Q.t2 * tri_energy(strain(tri2(Q), m), m);
  return e;
}

// vertex slot of the corner kRole in T1 / T2 of a quad, or -1 if absent
template <int kRole>
__device__ __forceinline__ int slot1(bool up) {
  if (kRole == kR00) return 0;
  if (kRole == kR10) return 1;
  if (kRole == kR11) return up ? 2 : -1;
  return up ? -1 : 2;  // kR01
}

template <int kRole>
__device__ __forceinline__ int slot2(bool up) {
  if (kRole == kR00) return up ? 0 : -1;
  if (kRole == kR10) return up ? -1 : 0;
  if (kRole == kR11) return 1;
  return 2;  // kR01
}

// g += t * d E(c) / d(vertex `slot`)
__device__ __forceinline__ void add_corner(const Corners& c, int slot,
                                           float t, const Material& m,
                                           float4* g) {
  float4 c0, c1;
  corner_cotangents(strain(c, m), m, &c0, &c1);
  const float4 d =
      slot == 0 ? c0
      : slot == 1 ? c1
                  : make_float4(-(c0.x + c1.x), -(c0.y + c1.y),
                                -(c0.z + c1.z), -(c0.w + c1.w));
  g->x += t * d.x;
  g->y += t * d.y;
  g->z += t * d.z;
  g->w += t * d.w;
}

template <int kRole>
__device__ __forceinline__ void add_quad(const Quad& Q, const Material& m,
                                         float4* g) {
  const int s1 = slot1<kRole>(Q.up);
  if (s1 >= 0 && Q.t1 != 0.f) add_corner(tri1(Q), s1, Q.t1, m, g);
  const int s2 = slot2<kRole>(Q.up);
  if (s2 >= 0 && Q.t2 != 0.f) add_corner(tri2(Q), s2, Q.t2, m, g);
}

// K7: thread n = i*ny + j adds the energy of quad (i, j).
template <int kDiag, bool kMasked>
__global__ void __launch_bounds__(kThreads)
stencil_fwd_kernel(Lattice L, Material m, float* __restrict__ partials) {
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  if (n < (long long)L.nx * L.ny) {
    const int i = (int)(n / L.ny);
    const int j = (int)(n - (long long)i * L.ny);
    if (i < L.nx - 1 && j < L.ny - 1)
      acc = quad_energy(load_quad<kDiag, kMasked>(L, i, j), m);
  }
  const float total = block_sum<float, kThreads / 32>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// K6: thread n = i*ny + j adds the energy of quad (i, j) and writes the
// gradient of node (i, j), summed over its quads in a fixed order.
template <int kDiag, bool kMasked>
__global__ void __launch_bounds__(kThreads)
stencil_vg_kernel(Lattice L, Material m, float4* __restrict__ grad,
                  float* __restrict__ partials) {
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  if (n < (long long)L.nx * L.ny) {
    const int i = (int)(n / L.ny);
    const int j = (int)(n - (long long)i * L.ny);
    const bool lo_i = i > 0, lo_j = j > 0;
    const bool hi_i = i < L.nx - 1, hi_j = j < L.ny - 1;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    if (lo_i && lo_j)
      add_quad<kR11>(load_quad<kDiag, kMasked>(L, i - 1, j - 1), m, &g);
    if (lo_i && hi_j)
      add_quad<kR10>(load_quad<kDiag, kMasked>(L, i - 1, j), m, &g);
    if (hi_i && lo_j)
      add_quad<kR01>(load_quad<kDiag, kMasked>(L, i, j - 1), m, &g);
    if (hi_i && hi_j) {
      const Quad Q = load_quad<kDiag, kMasked>(L, i, j);
      acc = quad_energy(Q, m);
      add_quad<kR00>(Q, m, &g);
    }
    grad[n] = g;
  }
  const float total = block_sum<float, kThreads / 32>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

template <int kDiag, bool kMasked>
cudaError_t launch(bool vg, const Lattice& L, const Material& m,
                   float4* grad, float* partials, int n_partials,
                   float* out, cudaStream_t st) {
  if (vg)
    stencil_vg_kernel<kDiag, kMasked><<<n_partials, kThreads, 0, st>>>(
        L, m, grad, partials);
  else
    stencil_fwd_kernel<kDiag, kMasked><<<n_partials, kThreads, 0, st>>>(
        L, m, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  sum_partials_kernel<<<1, kSumThreads, 0, st>>>(partials, n_partials, out);
  return cudaGetLastError();
}

template <int kDiag>
cudaError_t launch_masked(bool vg, const Lattice& L, const Material& m,
                          float4* grad, float* partials, int n_partials,
                          float* out, cudaStream_t st) {
  if (L.t1 != nullptr)
    return launch<kDiag, true>(vg, L, m, grad, partials, n_partials, out,
                               st);
  return launch<kDiag, false>(vg, L, m, grad, partials, n_partials, out,
                              st);
}

int run(int device, bool vg, const void* node, int nx, int ny, int diag,
        int phase, const void* sel, const void* t1, const void* t2, float f,
        float nu, float shear, float w_sum, void* grad, void* partials,
        int n_partials, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Lattice L{(const float4*)node, nx, ny, (const float*)sel,
                  (const float*)t1, (const float*)t2, phase};
  const Material m = material(f, nu, shear, w_sum);
  float4* g = (float4*)grad;
  float* p = (float*)partials;
  float* o = (float*)out;
  cudaStream_t st = (cudaStream_t)stream;
  switch (diag) {
    case kUp:
      return (int)launch_masked<kUp>(vg, L, m, g, p, n_partials, o, st);
    case kDown:
      return (int)launch_masked<kDown>(vg, L, m, g, p, n_partials, o, st);
    case kSelMask:
      return (int)launch_masked<kSelMask>(vg, L, m, g, p, n_partials, o,
                                          st);
    case kParity:
      return (int)launch_masked<kParity>(vg, L, m, g, p, n_partials, o, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int hdnn_lattice_threads_per_block() { return kThreads; }

// K7: the energy of the lattice into *out (device float).  diag: 0 up,
// 1 down, 2 per-quad sel mask, 3 zigzag parity with `phase`; t1 == NULL
// means every triangle is present.  partials must hold
// ceil(nx * ny / kThreads) floats.  Returns cudaGetLastError() after the
// launches.
int hdnn_lattice_stencil_fwd(int device, const void* node, int nx, int ny,
                             int diag, int phase, const void* sel,
                             const void* t1, const void* t2, float f,
                             float nu, float shear, float w_sum,
                             void* partials, int n_partials, void* out,
                             void* stream) {
  return run(device, false, node, nx, ny, diag, phase, sel, t1, t2, f, nu,
             shear, w_sum, nullptr, partials, n_partials, out, stream);
}

// K6: as K7, and the node gradient [nx * ny, 4] (float4 rows) into grad.
int hdnn_lattice_stencil_vg(int device, const void* node, int nx, int ny,
                            int diag, int phase, const void* sel,
                            const void* t1, const void* t2, float f,
                            float nu, float shear, float w_sum, void* grad,
                            void* partials, int n_partials, void* out,
                            void* stream) {
  return run(device, true, node, nx, ny, diag, phase, sel, t1, t2, f, nu,
             shear, w_sum, grad, partials, n_partials, out, stream);
}

const char* hdnn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
