// Banded P1 plane-stress energy and its node gradient, for Hopper.
//
// Replaces the TPU kernels of hidenn_fem_tpu/ops/banded_energy.py:
//   K3  _pallas_fwd (pallas_call at banded_energy.py:116): the energy sum
//       of a block of table rows
//   K4  _pallas_vg  (pallas_call at banded_energy.py:133): the energy of
//       the owned rows and the cotangents of all rows, in one pass
//   K5  _pallas_bwd (pallas_call at banded_energy.py:159): the cotangents
//       of all rows
// together with the incidence gathers around them that the JAX package
// left to XLA (_recompute_vg, _recompute_bwd, _two_pass_bwd).
//
// A table row holds k node slots, and node index = start[block] + rel:
//   k = 3  one triangle (0, 1, 2)
//   k = 4  an edge pair: triangles (0, 1, 2) and (0, 1, 3)
//   k = 6  a strip: triangle i = slots (i, i+1, i+2), i = 0..3
// (the three layouts of _lanes_any, banded_energy.py:58).  Each triangle's
// energy and cotangents are those of p1_triangle.cuh, shared with K1, K2,
// K6 and K7.  Filler pairs (slot 3 == slot 0), dead strip slots and the
// padding rows (the last element's first node repeated) are degenerate
// triangles: det == 0 exactly, and the eps guard makes their energy and
// cotangents exactly 0, so no row needs a mask.
//
// The TPU kernels ran on a lane-major [k*4, 2048-column] copy of the
// gathered corners, zero-padded to 2048 columns, one grid step per block
// with a scalar SMEM accumulator.  Here one thread takes one table row:
// it reads its k node rows as float4 straight from the [N, 4] table (the
// window gather is fused), and keeps every intermediate in registers.
// Nothing is transposed and nothing is padded.
//
// What bounds it on the H100: bytes, not arithmetic.  A paired row reads
// 16 B of indices (one int4 load) and four 16 B node rows (mostly from L2:
// neighbouring rows share nodes) for two triangles (~60 flops each; ~150
// more for the cotangents).  The element algebra is scalar and per
// triangle: there is no matrix product for the tensor cores to take.
//
// Value and gradient (K4, "vg"): one launch over the recompute windows,
// no cotangent buffer.  Thread t < n_rows adds the energy of row t to its
// block's partial when the row's node block owns it ([own_lo, own_hi): the
// ownership intervals partition the elements, so each element counts once
// though halo rows lie in two windows).  Thread t < n_nodes recomputes the
// gradient of node t: node block b = t / NB holds nodes [b*NB, (b+1)*NB)
// (the rows are placed at 0), and for each slot r of its re_inc_rel row,
// in slot order and skipping the sentinel k*EW, it loads row b*EW + r/k
// (its k indices and k node rows) and adds the cotangent of vertex r%k:
// the corner terms of the row's triangles that hold the vertex, added in
// triangle order to zero exactly as row_cotangents adds them.  So every
// term is the float the cotangent buffer of the two-launch design held,
// summed in the same order: the gradient keeps its bits, and K5 (which
// keeps the two launches, for the fallbacks) gives ct x K4 exactly.
// Each triangle is evaluated once per vertex (about 3x the flops of one
// row pass) in exchange for the ~30 MB a call that the buffer cost in
// device-memory writes and reads at 898K elements; the node and row tables
// (~15 MB) stay in the 50 MB L2, and RCM order keeps neighbouring threads
// on shared rows.  The TPU kernel's per-block scratch had no counterpart
// to keep.
//
// K5 evaluates every row's cotangents into a [B, EB, k] buffer, then gives
// each node the sum of its incidence slots' cotangent rows in slot order,
// skipping the sentinel slot (the TPU path appended a zero row for it).
//
// Determinism: per-block partials reduced in a fixed tree order, then a
// one-block double sum in a fixed order; each node's slots are summed in
// slot order.  No atomics.
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

template <int K>
__host__ __device__ constexpr int n_tris() {
  return K == 3 ? 1 : (K == 4 ? 2 : 4);
}

// slots (a, b, c) of triangle t of a k-slot row
template <int K>
__device__ __forceinline__ void tri_slots(int t, int* a, int* b, int* c) {
  if (K == 4) {
    *a = 0;
    *b = 1;
    *c = t == 0 ? 2 : 3;
  } else {  // K == 3 (t == 0) and K == 6
    *a = t;
    *b = t + 1;
    *c = t + 2;
  }
}

// The k node rows of table row `row` of block `blk`.  A paired row's four
// indices come in one 16 B load (the wrappers check rel's alignment), a
// strip's six in three 8 B loads.
template <int K>
__device__ __forceinline__ void load_row(const float4* __restrict__ node,
                                         const int* __restrict__ starts,
                                         const int* __restrict__ rel,
                                         long long blk, long long row,
                                         float4* v) {
  const long long s = __ldg(starts + blk);
  int r[K];
  if constexpr (K == 4) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(rel) + row);
    r[0] = q.x;
    r[1] = q.y;
    r[2] = q.z;
    r[3] = q.w;
  } else if constexpr (K == 6) {
    const int2* p = reinterpret_cast<const int2*>(rel) + row * 3;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const int2 q = __ldg(p + i);
      r[2 * i] = q.x;
      r[2 * i + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) r[i] = __ldg(rel + row * K + i);
  }
#pragma unroll
  for (int i = 0; i < K; ++i) v[i] = __ldg(node + s + r[i]);
}

template <int K>
__device__ __forceinline__ float row_energy(const float4* v,
                                            const Material& m) {
  float e = 0.f;
#pragma unroll
  for (int t = 0; t < n_tris<K>(); ++t) {
    int a, b, c;
    tri_slots<K>(t, &a, &b, &c);
    const float et = tri_energy(strain(Corners{v[a], v[b], v[c]}, m), m);
    e = t == 0 ? et : e + et;
  }
  return e;
}

__device__ __forceinline__ void add4(float4* acc, const float4& x) {
  acc->x += x.x;
  acc->y += x.y;
  acc->z += x.z;
  acc->w += x.w;
}

// Cotangents of the row's energy sum with respect to its k slots.
template <int K>
__device__ __forceinline__ void row_cotangents(const float4* v,
                                               const Material& m,
                                               float4* cot) {
#pragma unroll
  for (int i = 0; i < K; ++i) cot[i] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int t = 0; t < n_tris<K>(); ++t) {
    int a, b, c;
    tri_slots<K>(t, &a, &b, &c);
    const Strain s = strain(Corners{v[a], v[b], v[c]}, m);
    float4 c0, c1;
    corner_cotangents(s, m, &c0, &c1);
    add4(&cot[a], c0);
    add4(&cot[b], c1);
    add4(&cot[c], make_float4(-(c0.x + c1.x), -(c0.y + c1.y),
                              -(c0.z + c1.z), -(c0.w + c1.w)));
  }
}

// K3: one thread per table row (n_blocks x rows_per_block rows); one
// partial energy per thread block.
template <int K>
__global__ void __launch_bounds__(kThreads)
banded_fwd_kernel(const float4* __restrict__ node,
                  const int* __restrict__ starts,
                  const int* __restrict__ rel, long long rows_per_block,
                  long long n_rows, Material m,
                  float* __restrict__ partials) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  if (i < n_rows) {
    float4 v[K];
    load_row<K>(node, starts, rel, i / rows_per_block, i, v);
    acc = row_energy<K>(v, m);
  }
  const float total = block_sum<float, kThreads / 32>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// The cotangent of slot s of a row with respect to its energy: what
// row_cotangents leaves in cot[s], the same terms added in the same order.
template <int K>
__device__ __forceinline__ float4 slot_cotangent(const float4* v, int s,
                                                 const Material& m) {
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int t = 0; t < n_tris<K>(); ++t) {
    int a, b, c;
    tri_slots<K>(t, &a, &b, &c);
    if (s != a && s != b && s != c) continue;
    const Strain st = strain(Corners{v[a], v[b], v[c]}, m);
    float4 c0, c1;
    corner_cotangents(st, m, &c0, &c1);
    if (s == a)
      add4(&acc, c0);
    else if (s == b)
      add4(&acc, c1);
    else
      add4(&acc, make_float4(-(c0.x + c1.x), -(c0.y + c1.y),
                             -(c0.z + c1.z), -(c0.w + c1.w)));
  }
  return acc;
}

// K4: thread i adds the energy of recompute row i (when its block owns
// it) to the block's partial, and writes the gradient of node i,
// recomputed per incidence slot (the source's header says how).
template <int K>
__global__ void __launch_bounds__(kThreads)
banded_vg_kernel(const float4* __restrict__ node,
                 const int* __restrict__ starts,
                 const int* __restrict__ rel,
                 const int* __restrict__ own_lo,
                 const int* __restrict__ own_hi, long long rows_per_block,
                 long long n_rows, const int* __restrict__ inc_rel,
                 long long nodes_per_block, int degree, long long n_nodes,
                 Material m, float* __restrict__ partials,
                 float4* __restrict__ grad) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  float acc = 0.f;
  if (i < n_rows) {
    const long long blk = i / rows_per_block;
    const long long e = i - blk * rows_per_block;
    if (e >= __ldg(own_lo + blk) && e < __ldg(own_hi + blk)) {
      float4 v[K];
      load_row<K>(node, starts, rel, blk, i, v);
      acc = row_energy<K>(v, m);
    }
  }
  if (i < n_nodes) {
    const long long b = i / nodes_per_block;
    const int sentinel = (int)(rows_per_block * K);
    const int* slots = inc_rel + i * degree;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int d = 0; d < degree; ++d) {
      const int r = __ldg(slots + d);
      if (r == sentinel) continue;
      float4 v[K];
      load_row<K>(node, starts, rel, b, b * rows_per_block + r / K, v);
      add4(&g, slot_cotangent<K>(v, r % K, m));
    }
    grad[i] = g;
  }
  const float total = block_sum<float, kThreads / 32>(acc);
  if (threadIdx.x == 0) partials[blockIdx.x] = total;
}

// K5: every row's cotangents cot[row * K + slot].
template <int K>
__global__ void __launch_bounds__(kThreads)
banded_bwd_kernel(const float4* __restrict__ node,
                  const int* __restrict__ starts,
                  const int* __restrict__ rel, long long rows_per_block,
                  long long n_rows, Material m, float4* __restrict__ cot) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n_rows) return;
  float4 v[K];
  load_row<K>(node, starts, rel, i / rows_per_block, i, v);
  float4 c[K];
  row_cotangents<K>(v, m, c);
#pragma unroll
  for (int s = 0; s < K; ++s) cot[i * K + s] = c[s];
}

// Node gradients: grad[n] = scale * sum over the slots d of node n's
// incidence row (block b = n / nodes_per_block) of cot[base_b + rel],
// slots equal to `sentinel` skipped.  base_b = block_starts[b] when given
// (the two-pass windows), else b * block_stride (the recompute windows).
__global__ void __launch_bounds__(kThreads)
banded_node_sum_kernel(const float4* __restrict__ cot,
                       const int* __restrict__ inc_rel,
                       long long nodes_per_block, int degree,
                       const int* __restrict__ block_starts,
                       long long block_stride, int sentinel,
                       long long n_nodes, const float* __restrict__ scale,
                       float4* __restrict__ grad) {
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= n_nodes) return;
  const long long b = n / nodes_per_block;
  const long long base =
      block_starts != nullptr ? (long long)__ldg(block_starts + b)
                              : b * block_stride;
  const int* row = inc_rel + n * degree;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int d = 0; d < degree; ++d) {
    const int r = __ldg(row + d);
    if (r != sentinel) add4(&acc, __ldg(cot + base + r));
  }
  if (scale != nullptr) {
    const float k = __ldg(scale);
    acc = make_float4(acc.x * k, acc.y * k, acc.z * k, acc.w * k);
  }
  grad[n] = acc;
}

unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

int hdnn_banded_threads_per_block() { return kThreads; }

// K3: energy of the table (starts [B], rel [B, rows_per_block, k]) into
// *out; partials must hold ceil(n_rows / kThreads) floats.
int hdnn_banded_fwd(int device, const void* node, const void* starts,
                    const void* rel, long long rows_per_block,
                    long long n_rows, int k, float f, float nu, float shear,
                    float w_sum, void* partials, int n_partials, void* out,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const Material m = material(f, nu, shear, w_sum);
  const float4* nd = (const float4*)node;
  const int* s = (const int*)starts;
  const int* r = (const int*)rel;
  float* p = (float*)partials;
  switch (k) {
    case 3:
      banded_fwd_kernel<3><<<n_partials, kThreads, 0, st>>>(
          nd, s, r, rows_per_block, n_rows, m, p);
      break;
    case 4:
      banded_fwd_kernel<4><<<n_partials, kThreads, 0, st>>>(
          nd, s, r, rows_per_block, n_rows, m, p);
      break;
    case 6:
      banded_fwd_kernel<6><<<n_partials, kThreads, 0, st>>>(
          nd, s, r, rows_per_block, n_rows, m, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, kSumThreads, 0, st>>>(p, n_partials,
                                                (float*)out);
  return (int)cudaGetLastError();
}

// K4: the owned rows' energy into *out and the node gradient [n_nodes, 4]
// into grad, from the recompute tables (starts = re_nstarts, rel =
// re_conn_rel [Br, EW, k], own_lo/own_hi [Br], inc_rel = re_inc_rel
// [Br, nodes_per_block, degree], sentinel k*EW), in one launch and the
// partial sum; partials must hold ceil(max(n_rows, n_nodes) / kThreads)
// floats.
int hdnn_banded_vg(int device, const void* node, const void* starts,
                   const void* rel, const void* own_lo, const void* own_hi,
                   long long rows_per_block, long long n_rows, int k,
                   float f, float nu, float shear, float w_sum,
                   void* partials, int n_partials, void* out,
                   const void* inc_rel, long long nodes_per_block,
                   int degree, long long n_nodes, void* grad, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const Material m = material(f, nu, shear, w_sum);
  const float4* nd = (const float4*)node;
  const int* s = (const int*)starts;
  const int* r = (const int*)rel;
  const int* lo = (const int*)own_lo;
  const int* hi = (const int*)own_hi;
  const int* inc = (const int*)inc_rel;
  float* p = (float*)partials;
  float4* g = (float4*)grad;
  switch (k) {
    case 3:
      banded_vg_kernel<3><<<n_partials, kThreads, 0, st>>>(
          nd, s, r, lo, hi, rows_per_block, n_rows, inc, nodes_per_block,
          degree, n_nodes, m, p, g);
      break;
    case 4:
      banded_vg_kernel<4><<<n_partials, kThreads, 0, st>>>(
          nd, s, r, lo, hi, rows_per_block, n_rows, inc, nodes_per_block,
          degree, n_nodes, m, p, g);
      break;
    case 6:
      banded_vg_kernel<6><<<n_partials, kThreads, 0, st>>>(
          nd, s, r, lo, hi, rows_per_block, n_rows, inc, nodes_per_block,
          degree, n_nodes, m, p, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_partials_kernel<<<1, kSumThreads, 0, st>>>(p, n_partials,
                                                (float*)out);
  return (int)cudaGetLastError();
}

// K5: the node gradient [n_nodes, 4] times *scale into grad.  The row
// cotangents of the table (starts, rel [B, rows_per_block, k]) go to cot
// (n_rows * k float4), and node n sums the slots of inc_rel
// [Bn, nodes_per_block, degree] relative to block_starts[b] (the two-pass
// ct_starts) or, when block_starts is null, to b * rows_per_block * k (the
// recompute windows); slots equal to `sentinel` are skipped.
int hdnn_banded_bwd(int device, const void* node, const void* starts,
                    const void* rel, long long rows_per_block,
                    long long n_rows, int k, float f, float nu, float shear,
                    float w_sum, void* cot, const void* inc_rel,
                    long long nodes_per_block, int degree,
                    const void* block_starts, int sentinel,
                    long long n_nodes, const void* scale, void* grad,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const Material m = material(f, nu, shear, w_sum);
  const float4* nd = (const float4*)node;
  const int* s = (const int*)starts;
  const int* r = (const int*)rel;
  float4* c = (float4*)cot;
  const unsigned rb = blocks_for(n_rows);
  switch (k) {
    case 3:
      banded_bwd_kernel<3><<<rb, kThreads, 0, st>>>(nd, s, r, rows_per_block,
                                                    n_rows, m, c);
      break;
    case 4:
      banded_bwd_kernel<4><<<rb, kThreads, 0, st>>>(nd, s, r, rows_per_block,
                                                    n_rows, m, c);
      break;
    case 6:
      banded_bwd_kernel<6><<<rb, kThreads, 0, st>>>(nd, s, r, rows_per_block,
                                                    n_rows, m, c);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  banded_node_sum_kernel<<<blocks_for(n_nodes), kThreads, 0, st>>>(
      c, (const int*)inc_rel, nodes_per_block, degree,
      (const int*)block_starts, rows_per_block * k, sentinel, n_nodes,
      (const float*)scale, (float4*)grad);
  return (int)cudaGetLastError();
}

const char* hdnn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
