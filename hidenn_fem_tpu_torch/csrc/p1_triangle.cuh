// The P1 plane-stress triangle, shared by every kernel of the port that
// evaluates it (element_energy.cu: K1, K2; lattice_stencil.cu: K6, K7), so
// that the energy and its hand-derived cotangent exist once.
//
// Per triangle (v0, v1, v2), with a = v0 - v2, b = v1 - v2, d0 = u0 - u2,
// d1 = u1 - u2 (the formula of hidenn_fem_tpu/ops/pallas_energy.py:19-28):
//   det = ax*by - bx*ay, guarded to +-1e-12 when |det| < 1e-12
//   exx = ( by*d0x - ay*d1x) / det
//   eyy = (-bx*d0y + ax*d1y) / det
//   gxy = (by*d0y - ay*d1y - bx*d0x + ax*d1x) / det
//   dens = f/2 (exx^2 + eyy^2 + 2 nu exx eyy) + f(1-nu)/4 gxy^2
//   E_tri = w_sum * |det| * dens
//
// Conventions kept from the JAX package: d|det|/d det = +1 at det == 0
// (jax.grad(jnp.abs)(0.0) == 1), and det is computed without FMA
// contraction so that collinear and degenerate triangles give det == 0
// exactly, as the plain versions do.  The guard keeps every cotangent
// finite, so a caller may multiply an absent triangle's by 0 or skip it.
//
// Also here, block_sum and sum_partials_kernel: a second launch of one
// block that sums the per-block partials of an energy launch in double in
// a fixed order (K1, K3, K8).  energy_tail.cuh does the same sum inside
// the launch (K4, K6, K7).

#pragma once

#include <cuda_runtime.h>

namespace hdnn {

constexpr int kSumThreads = 1024;
constexpr float kEpsDet = 1e-12f;

struct Material {
  float f;       // E / (1 - nu^2)
  float nu;
  float two_nu;  // 2 nu
  float shear;   // f (1 - nu) / 2
  float w_sum;   // quadrature weight sum (triangle area factor)
};

inline Material material(float f, float nu, float shear, float w_sum) {
  return {f, nu, 2.f * nu, shear, w_sum};
}

struct Corners {
  float4 v0, v1, v2;  // (cx, cy, ux, uy) of the three vertices
};

struct Strain {
  float ax, ay, bx, by, d0x, d0y, d1x, d1y;
  float det, inv, P, Q, R, exx, eyy, gxy, dens;
  bool tiny;
};

__device__ __forceinline__ Strain strain(const Corners& c,
                                         const Material& m) {
  Strain s;
  s.ax = c.v0.x - c.v2.x;
  s.ay = c.v0.y - c.v2.y;
  s.bx = c.v1.x - c.v2.x;
  s.by = c.v1.y - c.v2.y;
  s.d0x = c.v0.z - c.v2.z;
  s.d0y = c.v0.w - c.v2.w;
  s.d1x = c.v1.z - c.v2.z;
  s.d1y = c.v1.w - c.v2.w;
  s.det = __fsub_rn(__fmul_rn(s.ax, s.by), __fmul_rn(s.bx, s.ay));
  s.tiny = fabsf(s.det) < kEpsDet;
  const float safe = s.tiny ? (s.det < 0.f ? -kEpsDet : kEpsDet) : s.det;
  s.inv = 1.0f / safe;
  s.P = s.by * s.d0x - s.ay * s.d1x;
  s.Q = -s.bx * s.d0y + s.ax * s.d1y;
  s.R = (s.by * s.d0y - s.ay * s.d1y) + (-s.bx * s.d0x + s.ax * s.d1x);
  s.exx = s.P * s.inv;
  s.eyy = s.Q * s.inv;
  s.gxy = s.R * s.inv;
  s.dens = 0.5f * (m.f * (s.exx * s.exx + s.eyy * s.eyy
                          + m.two_nu * s.exx * s.eyy)
                   + m.shear * s.gxy * s.gxy);
  return s;
}

// w_sum |det| dens
__device__ __forceinline__ float tri_energy(const Strain& s,
                                            const Material& m) {
  return m.w_sum * fabsf(s.det) * s.dens;
}

// d E_tri / d v0 and d E_tri / d v1 (as (cx, cy, ux, uy)); the third
// vertex's is -(c0 + c1), since v2 enters only through a, b, d0 and d1.
__device__ __forceinline__ void corner_cotangents(const Strain& s,
                                                  const Material& m,
                                                  float4* c0, float4* c1) {
  // d E / d (exx, eyy, gxy) = w_sum |det| * stress
  const float A = m.w_sum * fabsf(s.det);
  const float gexx = A * (m.f * (s.exx + m.nu * s.eyy));
  const float geyy = A * (m.f * (s.eyy + m.nu * s.exx));
  const float ggxy = A * (m.shear * s.gxy);
  const float gP = gexx * s.inv;
  const float gQ = geyy * s.inv;
  const float gR = ggxy * s.inv;
  const float ginv = gexx * s.P + geyy * s.Q + ggxy * s.R;
  const float sgn = s.det >= 0.f ? 1.f : -1.f;
  float gdet = m.w_sum * sgn * s.dens;
  if (!s.tiny) gdet -= ginv * s.inv * s.inv;

  *c0 = make_float4(gQ * s.d1y + gR * s.d1x + gdet * s.by,
                    -gP * s.d1x - gR * s.d1y - gdet * s.bx,
                    gP * s.by - gR * s.bx,
                    -gQ * s.bx + gR * s.by);
  *c1 = make_float4(-gQ * s.d0y - gR * s.d0x - gdet * s.ay,
                    gP * s.d0x + gR * s.d0y + gdet * s.ax,
                    -gP * s.ay + gR * s.ax,
                    gQ * s.ax - gR * s.ay);
}

template <typename T, int kWarps>
__device__ __forceinline__ T block_sum(T v) {
  __shared__ T warp_sums[kWarps];
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = v;
  __syncthreads();
  T total = T(0);
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
  return total;  // valid in thread 0 only
}

// Sums the per-block partials in double, in a fixed order: lane l of
// kSumThreads adds partials l, l + kSumThreads, ...; then block_sum.
__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const float* __restrict__ partials, int n,
                    float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kSumThreads) acc += partials[i];
  const double total = block_sum<double, kSumThreads / 32>(acc);
  if (threadIdx.x == 0) *out = (float)total;
}

}  // namespace hdnn
