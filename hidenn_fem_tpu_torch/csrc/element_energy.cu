// Fused P1 plane-stress element energy and its cotangents, for Hopper.
//
// Replaces the TPU kernels of hidenn_fem_tpu/ops/pallas_energy.py:
//   K1  _forward  (pallas_call at pallas_energy.py:154): the energy sum
//   K2  _bwd_rule (pallas_call at pallas_energy.py:178): d(energy)/d(corners)
// Per element, with a = v0 - v2, b = v1 - v2, d0 = u0 - u2, d1 = u1 - u2:
//   det = ax*by - bx*ay, guarded to +-1e-12 when |det| < 1e-12
//   exx = ( by*d0x - ay*d1x) / det
//   eyy = (-bx*d0y + ax*d1y) / det
//   gxy = (by*d0y - ay*d1y - bx*d0x + ax*d1x) / det
//   dens = f/2 (exx^2 + eyy^2 + 2 nu exx eyy) + f(1-nu)/4 gxy^2
//   E_elem = w_sum * |det| * dens
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
// Conventions kept from the JAX package: d|det|/d det = +1 at det == 0
// (jax.grad(jnp.abs)(0.0) == 1), d max(x, c)/dx = 1/2 at a tie, and det
// is computed without FMA contraction so that collinear and degenerate
// elements give det == 0 exactly, as the plain versions do.
//
// Built by hidenn_fem_tpu_torch/ops/element_energy.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC
// and bound through the plain C interface at the end of this file.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSumThreads = 1024;
constexpr float kEpsDet = 1e-12f;
constexpr float kDsFloor = 1e-30f;

struct Material {
  float f;       // E / (1 - nu^2)
  float nu;
  float two_nu;  // 2 nu
  float shear;   // f (1 - nu) / 2
  float w_sum;   // quadrature weight sum (triangle area factor)
};

struct Corners {
  float4 v0, v1, v2;  // (cx, cy, ux, uy) of the three vertices
};

__device__ __forceinline__ Corners load_corners(
    const float4* __restrict__ node, const int* __restrict__ conn,
    long long e) {
  const int n0 = __ldg(conn + 3 * e);
  const int n1 = __ldg(conn + 3 * e + 1);
  const int n2 = __ldg(conn + 3 * e + 2);
  return {__ldg(node + n0), __ldg(node + n1), __ldg(node + n2)};
}

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

__device__ __forceinline__ float edge_len(const Corners& c, float* sx,
                                          float* sy, float* s2) {
  *sx = c.v0.x - c.v1.x;
  *sy = c.v0.y - c.v1.y;
  *s2 = *sx * *sx + *sy * *sy;
  return sqrtf(fmaxf(*s2, kDsFloor));
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
    acc = m.w_sum * fabsf(s.det) * s.dens;
    if (e >= edge_start) {
      float sx, sy, s2;
      const float ds = edge_len(c, &sx, &sy, &s2);
      acc += tw * (ds * 0.5f * (c.v0.z + c.v1.z));
    }
  }
  const float total = block_sum<float, kThreads / 32>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// Sums the per-block partials in double, in a fixed order.
__global__ void __launch_bounds__(kSumThreads)
sum_partials_kernel(const float* __restrict__ partials, int n,
                    float* __restrict__ out) {
  double acc = 0.0;
  for (int i = threadIdx.x; i < n; i += kSumThreads) acc += partials[i];
  const double total = block_sum<double, kSumThreads / 32>(acc);
  if (threadIdx.x == 0) *out = (float)total;
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

  const float g_ax = gQ * s.d1y + gR * s.d1x + gdet * s.by;
  const float g_ay = -gP * s.d1x - gR * s.d1y - gdet * s.bx;
  const float g_bx = -gQ * s.d0y - gR * s.d0x - gdet * s.ay;
  const float g_by = gP * s.d0x + gR * s.d0y + gdet * s.ax;
  const float g_d0x = gP * s.by - gR * s.bx;
  const float g_d0y = -gQ * s.bx + gR * s.by;
  const float g_d1x = -gP * s.ay + gR * s.ax;
  const float g_d1y = gQ * s.ax - gR * s.ay;

  float4 c0 = make_float4(g_ax, g_ay, g_d0x, g_d0y);
  float4 c1 = make_float4(g_bx, g_by, g_d1x, g_d1y);
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
  // vertex 2 enters the elastic term only through a, b, d0 and d1 (and
  // not the edge term): minus their sums
  const float4 v2 = make_float4(-(g_ax + g_bx), -(g_ay + g_by),
                                -(g_d0x + g_d1x), -(g_d0y + g_d1y));
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

Material material(float f, float nu, float shear, float w_sum) {
  return {f, nu, 2.f * nu, shear, w_sum};
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
