// Banded P1 plane-stress energy and its node gradient, for Hopper.
//
// Replaces the TPU kernels of hidenn_fem_tpu/ops/banded_energy.py:
//   K3  _pallas_fwd (pallas_call at banded_energy.py:116): the energy sum
//       of a block of table rows
//   K4  _pallas_vg  (pallas_call at banded_energy.py:133): the energy of
//       the owned rows and the cotangents of all rows, in one pass
//   K5  _pallas_bwd (pallas_call at banded_energy.py:159): the cotangents
//       of all rows (driven by _recompute_bwd :232 and _two_pass_bwd :300)
// together with the incidence gathers around them that the JAX package
// left to XLA (_recompute_vg, _recompute_bwd, _two_pass_bwd): K4 and K5
// return node gradients.
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
// The node gradient (K4's second half, and K5): one thread per node, no
// cotangent buffer.  Thread n lies in node block b = n / NB, which holds
// table rows [b*NB, (b+1)*NB), placed at global node rows row_start + n:
// row_start is 0 for the whole tables, and for the contiguous slice of
// node blocks that one rank of an element-sharded run walks
// (hidenn_fem_tpu/parallel/sharding.py:211-280) it is the slice's first
// table row, as in the TPU package's [N + R] buffer trimmed to N
// (banded_energy.py:232-297).  The wrapper passes n_nodes, the rows that
// land below N, so no thread writes past the node table.  A slice's
// re_nstarts are global node rows, so its slots decode as in the whole
// tables: each placed row gets the bits of the unsharded launch.  The thread walks
// the degree slots of its incidence row in slot order, skips the
// sentinel, decodes each slot r to a table row and a vertex, loads the
// row (its k indices and k node rows) and adds the vertex's cotangent: the
// corner terms of the row's triangles that hold the vertex, added in
// triangle order to zero.  The decode depends on the windows:
//   recompute windows (K4; K5 when the tables have them): row b*EW + r/k,
//     vertex r%k, node window re_nstarts[b], sentinel k*EW;
//   two-pass windows (K5 without recompute tables): c = ct_starts[b] + r
//     is the flat cotangent row global_row*k + vertex of the JAX
//     package's _two_pass_bwd, so row c/k, vertex c%k, forward block
//     row/EB, node window starts[row/EB], sentinel wct.
// Both name the elements of the node's incidence row in its order, and
// the same global nodes, so every term is the float that a [rows*k, 4]
// cotangent buffer would hold, summed in slot order: K5 gives the same
// bits on both kinds, and K5 = ct x K4 exactly (the multiply by *ct comes
// after the sum, as autograd's ct x K4 does).  Each triangle is evaluated
// once per vertex (about 3x the flops of one row pass) in exchange for the
// ~60 MB a call that the buffer cost in device-memory writes and reads at
// 898K elements; the node and row tables (~15 MB) stay in the 50 MB L2
// (read through __ldg), and RCM order keeps neighbouring threads on shared
// rows.  The TPU kernel's per-block scratch had no counterpart to keep.
// The slots are read by their own thread: a node's row is degree
// contiguous int32, so a warp's first slot load brings its 32 rows
// (32 x degree x 4 B) into L1 and its later slot loads hit there.  Staging
// the rows in shared memory first (per CTA or per warp, with coalesced
// 16 B loads) measured slower in both kernels on the 898K paired and
// triangle tables, so the kernels do not stage them.
//
// Value and gradient (K4, "vg"): one launch over the recompute windows.
// Thread t < n_rows adds the energy of row t to its block's partial when
// the row's node block owns it ([own_lo, own_hi): the ownership intervals
// partition the elements, so each element counts once though halo rows
// lie in two windows); thread t < n_nodes writes the gradient of node t.
// The grid's last block adds the partials as they land (energy_tail of
// energy_tail.cuh), and CTAs after the row and node blocks write +0.0 to
// every row of the [N, 4] output outside [row_start, row_start +
// n_nodes) (zero_rows_outside; none for the whole tables), so a call is
// one launch and the wrapper fills nothing first: a rank's slice, even
// one that places no row, comes back whole.
//
// The gradient alone, times *ct (K5, "grad"): the same node sum, with the
// same zero CTAs, and no energy.  Spreading a node's slots over 4 or 8
// lanes of a warp, added in slot order by the node's first lane (the same
// bits), shortens each thread's chain of dependent row loads but measured
// slower on the 898K tables, on a slice and on the whole tables (1.24x
// and 1.6x at 4 lanes, 2x and 2.8x at 8; PERF.md): the shuffles and the
// serial combine cost more than the shorter chains save.
//
// Determinism: per-block partials reduced in a fixed tree order, then a
// double sum in a fixed order (K3: a one-block second launch; K4: the
// grid's last block, in the same order); each node's slots are summed in
// slot order.  No atomic adds a value.
//
// Built by hidenn_fem_tpu_torch/ops/cuda_build.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I csrc
// and bound through the plain C interface at the end of this file.

#include <cuda_runtime.h>

#include "energy_tail.cuh"
#include "p1_triangle.cuh"

namespace {

using hdnn::Corners;
using hdnn::Material;
using hdnn::Strain;
using hdnn::Tail;
using hdnn::block_sum;
using hdnn::corner_cotangents;
using hdnn::energy_tail;
using hdnn::kSumThreads;
using hdnn::material;
using hdnn::strain;
using hdnn::sum_partials_kernel;
using hdnn::tail_tag;
using hdnn::tri_energy;
using hdnn::zero_blocks;
using hdnn::zero_rows_outside;

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

// The cotangent of slot s of a row with respect to its energy: the corner
// terms of the row's triangles that hold s, added to zero in triangle
// order (the terms, and the order, of the plain _row_cotangents).
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

// The unscaled gradient of node block b's node whose degree incidence
// slots are `slots`: the cotangents the slots name, summed in slot order
// (the source's header says how a slot decodes on each kind of window).
// `starts`/`rel` are the window tables the slots index: re_nstarts and
// re_conn_rel [Br, EW, k] for the recompute windows, starts and conn_rel
// [B, EB, k] with ct_starts for the two-pass windows (TwoPass).  The
// decode runs in 32 bits (every flat cotangent row of the int32 tables
// fits): a division by 3 or 6 costs more in 64.
template <int K, bool TwoPass>
__device__ __forceinline__ float4 node_gradient(
    const float4* __restrict__ node, const int* __restrict__ starts,
    const int* __restrict__ rel, long long rows_per_block,
    const int* __restrict__ slots, int degree, long long b,
    const int* __restrict__ ct_starts, int sentinel, const Material& m) {
  // the flat cotangent row that slot value 0 names: ct_starts[b] in the
  // whole [B*EB*k] array (two-pass), 0 in the block's window (recompute)
  const int base = TwoPass ? __ldg(ct_starts + b) : 0;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int d = 0; d < degree; ++d) {
    const int r = __ldg(slots + d);
    if (r == sentinel) continue;
    const unsigned c = (unsigned)(base + r);
    const unsigned q = c / K;
    const long long row = TwoPass ? (long long)q : b * rows_per_block + q;
    const long long blk =
        TwoPass ? (long long)(q / (unsigned)rows_per_block) : b;
    float4 v[K];
    load_row<K>(node, starts, rel, blk, row, v);
    add4(&g, slot_cotangent<K>(v, (int)(c - q * K), m));
  }
  return g;
}

// K4: thread i adds the energy of recompute row i (when its block owns
// it) to the block's partial, and writes the gradient of node row i into
// grad[row_start + i]; the CTAs past the E.n row and node blocks write
// +0.0 to the other rows of grad [n_out].
template <int K>
__global__ void __launch_bounds__(kThreads)
banded_vg_kernel(const float4* __restrict__ node,
                 const int* __restrict__ starts,
                 const int* __restrict__ rel,
                 const int* __restrict__ own_lo,
                 const int* __restrict__ own_hi, long long rows_per_block,
                 long long n_rows, const int* __restrict__ inc_rel,
                 long long nodes_per_block, int degree, long long n_nodes,
                 long long row_start, long long n_out, Material m, Tail E,
                 float4* __restrict__ grad) {
  if ((int)blockIdx.x >= E.n) {
    zero_rows_outside<kThreads>(grad, n_out, row_start, row_start + n_nodes,
                                blockIdx.x - E.n);
    energy_tail<kThreads>(0.f, -1, 0u, E);
    return;
  }
  const unsigned int tag = threadIdx.x == 0 ? tail_tag(E) : 0u;
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
  if (i < n_nodes)
    grad[row_start + i] = node_gradient<K, false>(
        node, starts, rel, rows_per_block, inc_rel + i * degree, degree,
        i / nodes_per_block, nullptr, (int)(rows_per_block * K), m);
  const float total = block_sum<float, kThreads / 32>(acc);
  energy_tail<kThreads>(total, blockIdx.x, tag, E);
}

// K5: grad[row_start + n] = *scale x the gradient of node row n, over the
// recompute windows or (TwoPass) the two-pass windows; the CTAs past the
// node_blocks write +0.0 to the other rows of grad [n_out].
template <int K, bool TwoPass>
__global__ void __launch_bounds__(kThreads)
banded_grad_kernel(const float4* __restrict__ node,
                   const int* __restrict__ starts,
                   const int* __restrict__ rel, long long rows_per_block,
                   const int* __restrict__ inc_rel,
                   long long nodes_per_block, int degree,
                   const int* __restrict__ ct_starts, int sentinel,
                   long long n_nodes, long long row_start, long long n_out,
                   long long node_blocks, Material m,
                   const float* __restrict__ scale,
                   float4* __restrict__ grad) {
  if ((long long)blockIdx.x >= node_blocks) {
    zero_rows_outside<kThreads>(grad, n_out, row_start, row_start + n_nodes,
                                blockIdx.x - node_blocks);
    return;
  }
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= n_nodes) return;
  const float4 g = node_gradient<K, TwoPass>(
      node, starts, rel, rows_per_block, inc_rel + n * degree, degree,
      n / nodes_per_block, ct_starts, sentinel, m);
  const float s = __ldg(scale);
  grad[row_start + n] = make_float4(g.x * s, g.y * s, g.z * s, g.w * s);
}

template <int K>
void launch_vg(cudaStream_t st, unsigned grid, const float4* node,
               const int* starts, const int* rel, const int* own_lo,
               const int* own_hi, long long rows_per_block, long long n_rows,
               const int* inc, long long nodes_per_block, int degree,
               long long n_nodes, long long row_start, long long n_out,
               const Material& m, const Tail& E, float4* grad) {
  banded_vg_kernel<K><<<grid, kThreads, 0, st>>>(
      node, starts, rel, own_lo, own_hi, rows_per_block, n_rows, inc,
      nodes_per_block, degree, n_nodes, row_start, n_out, m, E, grad);
}

template <int K, bool TwoPass>
void launch_grad(cudaStream_t st, const float4* node, const int* starts,
                 const int* rel, long long rows_per_block, const int* inc,
                 long long nodes_per_block, int degree, const int* ct_starts,
                 int sentinel, long long n_nodes, long long row_start,
                 long long n_out, const Material& m, const float* scale,
                 float4* grad) {
  const long long node_blocks = (n_nodes + kThreads - 1) / kThreads;
  const long long grid =
      node_blocks + zero_blocks<kThreads>(n_out - n_nodes);
  banded_grad_kernel<K, TwoPass><<<(unsigned)grid, kThreads, 0, st>>>(
      node, starts, rel, rows_per_block, inc, nodes_per_block, degree,
      ct_starts, sentinel, n_nodes, row_start, n_out, node_blocks, m, scale,
      grad);
}

template <int K>
void launch_grad_kind(bool two_pass, cudaStream_t st,
                      const float4* node, const int* starts, const int* rel,
                      long long rows_per_block, const int* inc,
                      long long nodes_per_block, int degree,
                      const int* ct_starts, int sentinel, long long n_nodes,
                      long long row_start, long long n_out, const Material& m,
                      const float* scale, float4* grad) {
  (two_pass ? launch_grad<K, true> : launch_grad<K, false>)(
      st, node, starts, rel, rows_per_block, inc, nodes_per_block,
      degree, ct_starts, sentinel, n_nodes, row_start, n_out, m, scale,
      grad);
}

// Registers per thread and resident CTAs per SM of one kernel.
template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int* regs, int* ctas) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(ctas, kernel, kThreads,
                                                       0);
}

template <int K>
cudaError_t occupancy_of(int which, int* regs, int* ctas) {
  switch (which) {
    case 0:
      return occupancy(banded_vg_kernel<K>, regs, ctas);
    case 1:
      return occupancy(banded_grad_kernel<K, false>, regs, ctas);
    case 2:
      return occupancy(banded_grad_kernel<K, true>, regs, ctas);
    default:
      return cudaErrorInvalidValue;
  }
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

// K4: the owned rows' energy into *out and grad [n_out, 4] whole: the
// gradient of the first n_nodes node rows of the tables in rows
// [row_start, row_start + n_nodes), +0.0 in every other row (whatever
// grad held before), from the recompute tables (starts = re_nstarts, rel
// = re_conn_rel [Br, EW, k], own_lo/own_hi [Br], inc_rel = re_inc_rel
// [Br, nodes_per_block, degree], sentinel k*EW), in one launch of
// n_partials = ceil(max(n_rows, n_nodes) / kThreads) energy blocks (0
// when both are 0: the launch then writes zeros and a zero energy) and
// the zero blocks.
int hdnn_banded_vg(int device, const void* node, const void* starts,
                   const void* rel, const void* own_lo, const void* own_hi,
                   long long rows_per_block, long long n_rows, int k,
                   float f, float nu, float shear, float w_sum,
                   int n_partials, void* out, const void* inc_rel,
                   long long nodes_per_block, int degree, long long n_nodes,
                   long long row_start, long long n_out, void* grad,
                   void* stream) {
  const long long grid =
      n_partials + zero_blocks<kThreads>(n_out - n_nodes);
  // a slice that places no row (n_nodes 0) may start past the table
  if (n_partials < 0 || n_nodes < 0 || row_start < 0 ||
      (n_nodes > 0 && row_start + n_nodes > n_out) || grid < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  // K4's blocks run long: each thread walks a node's slots
  Tail E = hdnn::make_tail(n_partials, grid, true, (float*)out);
  const int got = hdnn::tail_slot(device, st, &E);
  if (got != (int)cudaSuccess) return got;
  const Material m = material(f, nu, shear, w_sum);
  const float4* nd = (const float4*)node;
  const int* s = (const int*)starts;
  const int* r = (const int*)rel;
  const int* lo = (const int*)own_lo;
  const int* hi = (const int*)own_hi;
  const int* inc = (const int*)inc_rel;
  float4* g = (float4*)grad;
  switch (k) {
    case 3:
      launch_vg<3>(st, (unsigned)grid, nd, s, r, lo, hi, rows_per_block,
                   n_rows, inc, nodes_per_block, degree, n_nodes, row_start,
                   n_out, m, E, g);
      break;
    case 4:
      launch_vg<4>(st, (unsigned)grid, nd, s, r, lo, hi, rows_per_block,
                   n_rows, inc, nodes_per_block, degree, n_nodes, row_start,
                   n_out, m, E, g);
      break;
    case 6:
      launch_vg<6>(st, (unsigned)grid, nd, s, r, lo, hi, rows_per_block,
                   n_rows, inc, nodes_per_block, degree, n_nodes, row_start,
                   n_out, m, E, g);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// K5: grad [n_out, 4] whole: the gradient of the first n_nodes node rows
// of the tables times *scale in rows [row_start, row_start + n_nodes),
// +0.0 in every other row (whatever grad held before), in one launch, one
// thread a node.  Node row n sums the slots of
// inc_rel [Bn, nodes_per_block, degree] that are not `sentinel`, over the
// window tables starts/rel [B, rows_per_block, k]: the two-pass windows
// relative to ct_starts[b] when ct_starts is given, else the recompute
// windows.
int hdnn_banded_bwd(int device, const void* node, const void* starts,
                    const void* rel, long long rows_per_block, int k,
                    float f, float nu, float shear, float w_sum,
                    const void* inc_rel, long long nodes_per_block,
                    int degree, const void* ct_starts, int sentinel,
                    long long n_nodes, long long row_start, long long n_out,
                    const void* scale, void* grad, void* stream) {
  // a slice that places no row (n_nodes 0) may start past the table
  if (n_nodes < 0 || row_start < 0 || n_out < 1 ||
      (n_nodes > 0 && row_start + n_nodes > n_out) ||
      (k != 3 && k != 4 && k != 6))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  const Material m = material(f, nu, shear, w_sum);
  const float4* nd = (const float4*)node;
  const int* s = (const int*)starts;
  const int* r = (const int*)rel;
  const int* inc = (const int*)inc_rel;
  const int* cs = (const int*)ct_starts;
  const float* sc = (const float*)scale;
  float4* g = (float4*)grad;
  const bool two_pass = cs != nullptr;
  (k == 3   ? launch_grad_kind<3>
   : k == 4 ? launch_grad_kind<4>
            : launch_grad_kind<6>)(two_pass, st, nd, s, r,
                                   rows_per_block, inc, nodes_per_block,
                                   degree, cs, sentinel, n_nodes, row_start,
                                   n_out, m, sc, g);
  return (int)cudaGetLastError();
}

// Registers per thread (*regs) and resident CTAs per SM (*ctas) of K4
// (which 0), K5 over the recompute windows (1) or over the two-pass
// windows (2), for rows of k slots.
int hdnn_banded_occupancy(int device, int which, int k, int* regs,
                          int* ctas) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  switch (k) {
    case 3:
      return (int)occupancy_of<3>(which, regs, ctas);
    case 4:
      return (int)occupancy_of<4>(which, regs, ctas);
    case 6:
      return (int)occupancy_of<6>(which, regs, ctas);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* hdnn_error_string(int err) { return hdnn::error_string(err); }

}  // extern "C"
