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
// What bounds it on the H100: bytes and latency more than arithmetic.
// The node table is 16 B a node (7.4 MB at 462,241 nodes, inside the 50 MB
// L2); K6 reads it about once and writes the 16 B gradient, ~15 MB in all
// (~20 MB with the sel/t1/t2 masks), against ~100 flops for a triangle's
// energy and ~150 more for its cotangents.  The element algebra is scalar
// and per triangle: there is no matrix product for the tensor cores.  The
// TPU kernels packed the table into a channel-major [4, R, ceil128(ny)]
// slab, cut it into 8-row-aligned windows with halo rows and double-
// buffered their DMA; those were lane and VMEM layouts, not reproduced.
//
// K6 is a shared-memory tile.  A CTA of 256 threads owns a 7 x 31 node
// tile; thread (ty, tx) of its 8 x 32 quad tile takes quad
// (i0 - 1 + ty, j0 - 1 + tx), so the tile's quads and its one-quad halo
// are one quad per thread (warps run along j, so every load coalesces).
// The CTA copies the 9 x 33 node rows those quads touch into shared
// memory with cp.async (16 B a row; rows off the lattice are zero-filled
// and unused), while each thread loads its quad's sel/t1/t2.  Each thread
// then evaluates its quad once: the strain of each present triangle, its
// energy, and the cotangents of its three corners, which go to shared
// memory (6 float4 a quad) beside the quad's weights and diagonal.  After
// a barrier, thread (ty, tx) with ty, tx >= 1 writes the gradient of node
// (i0 - 1 + ty, j0 - 1 + tx): t * d over its <= 4 quads in a fixed order,
// (i-1, j-1) as corner n11, (i-1, j) as n10, (i, j-1) as n01, (i, j) as
// n00, T1 before T2 in each: a gather, so no atomics and the same bits on
// every run.  Each present triangle is evaluated 256 / 217 = 1.18 times
// per owned triangle (the halo), where the one-thread-per-node design
// before it evaluated each three times, once per corner, and reloaded
// every corner of four quads per node.
//
// Energy: thread (ty, tx) with ty, tx >= 1 adds the energy of the quad it
// owns (the quad whose n00 is its node) to the CTA's partial, and the
// grid's last CTA adds the partials in double in a fixed order as they
// land, in the same launch (energy_tail of energy_tail.cuh: the order and
// the bits of the one-block sum_partials_kernel, with no second launch).
// Tiles mask the ragged edges themselves: any nx, ny >= 2.  Each call is
// one launch.
//
// K7 needs no cotangents, so it keeps K6's tiles, its quad of each lane
// and its sums, and drops the rest: four warps walk a tile's 7 quad rows,
// kFwdWarpRows = 2 each, lane tx on K6's column tx.  A warp loads each
// node of its rows once, into registers (K7's earlier one-quad-a-thread
// core loaded each about four times), a quad's right-hand corners come
// from the next lane by shuffle and its lower corners serve the next quad
// row as its upper ones; K6's halo row, which adds nothing, takes no
// warp, and its halo column's lane loads the column right of the tile.
// Each quad row is summed by block_sum's warp tree and the tile's row
// sums are added in row order, so a tile's partial, and the energy, keep
// K6's bits.  A CTA is one tile.  (One warp over all 7 rows, four tiles a
// CTA, ran 2x slower: too few warps to hide a row's latency; PERF.md.)
//
// Row windows (the sharded lattice energy, hidenn_fem_tpu/parallel/
// sharded_slab.py, where the TPU kernels took a `row0` SMEM scalar that
// offset their window DMAs and ownership masks, lattice_slab.py:154-194,
// 317-320): both kernels walk the node rows [row_lo, row_hi) of the whole
// table.  The tiles start at row_lo, the stencil CTAs cover only the
// window's tiles (each stages its one-row halo above and below), node
// threads write only rows inside the window, and a quad counts its energy
// when its n00 row lies in the window.  Windows that partition [0, nx)
// thus partition the quads, and each node of a window gathers the same
// <= 4 quads, evaluated by the same code in the same order, as in the
// whole-lattice launch (row_lo = 0, row_hi = nx): its gradient has the
// same bits.  The sel/t1/t2 masks are read by global quad row.  (The TPU
// kernel owned a quad by its second row, lattice_slab.py:161-170; only
// the sum over windows is held to it.)
//
// K6's grid adds zero CTAs after the tiles: they write +0.0 to every node
// row outside the window (zero_rows_outside, 16 B a store, 2,048 rows a
// CTA), running beside the tiles, so the one launch writes the whole
// [nx * ny, 4] gradient and the wrapper never fills it first (the TPU
// kernel wrote the window's block and XLA placed it into zeros,
// hidenn_fem_tpu/parallel/sharded_slab.py:71-82).  A window narrower than
// a tile row (the sharded multigrid's 4-6 row windows of padded levels)
// is one row of tiles and mostly zero CTAs; the whole lattice has none.
//
// The multigrid level step (no TPU kernel: the JAX package's V-cycle,
// hidenn_fem_tpu/solve/multigrid.py _cheb_smooth/_vcycle, was XLA's fusion
// of K6 calls and vector updates).  A level operator is K v = the
// displacement columns of K6's gradient at (pinned coords, v with the
// Dirichlet rows 0), 0 on the Dirichlet rows: K6 computed it with an
// energy, the coordinate gradient and a tail, all thrown away, around a
// concatenation, a where and a subtraction, and each Chebyshev step added
// four or five vector passes, ~14 launches a step.  The level epilogues
// of stencil_vg_kernel (its third template argument kEpi != kEnergy) do a
// step in one launch: the CTA stages its tile's coordinates and the
// vector the operator acts on apart (zero on Dirichlet rows), evaluates
// only the displacement part of each quad's corner terms (the same
// strain and corner_cotangents code, the rest left to dead-code
// elimination), gathers each owned node's <= 4 quads in K6's order, and
// updates that node's vectors: r -= w, d' = c1 d + c2 dinv r, x += d'
// (kStep); from x = 0, whose stencil is exactly 0, the first step folded
// into the second (kFromZero); the residual b - K x (kResidual); the
// prolonged correction x + free P(xc), staged with the tile, and the
// post-smoother's first step (kPostFirst); K p (kMatvec).  Every update
// rounds each product and sum alone (__fmul_rn, __fadd_rn), as the torch
// composition's elementwise launches do, and a division by theta is a
// product with 1/theta in float, as torch divides a CUDA tensor by a
// scalar.  A launch reads one vector with its halo and writes others, so
// neighbouring tiles never read what a launch writes (the wrapper passes
// fresh outputs).  Full-weighting restriction is one launch of
// restrict_kernel (both axes, _restrict_axis's addition order).  What
// bounds a step: bytes (coordinates, the staged vector and its halo, b or
// r, x, dinv: ~40-56 B a node read, 24 written) and, below ~100K nodes,
// the launch itself.
//
// The bottom of the cycle, the levels of at most kBottomNodes nodes, runs
// in one launch of one CTA (level_bottom_kernel): the same passes over a
// whole level, its quads' corner terms in dynamic shared memory, and a
// block barrier between passes, the down leg, the coarsest smoothing and
// the up leg in one kernel.  One CTA may update its vectors in place: a
// pass reads the staged vector in its first phase and each node's own
// entries in its last.
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
using hdnn::Tail;
using hdnn::block_sum;
using hdnn::corner_cotangents;
using hdnn::energy_tail;
using hdnn::material;
using hdnn::strain;
using hdnn::tail_finish;
using hdnn::tail_put;
using hdnn::tail_tag;
using hdnn::tri_energy;
using hdnn::zero_blocks;
using hdnn::zero_rows_outside;

// the quad tile (one quad a thread) and the node tile it owns
constexpr int kQuadRows = 8;
constexpr int kQuadCols = 32;
constexpr int kThreads = kQuadRows * kQuadCols;
constexpr int kTileRows = kQuadRows - 1;
constexpr int kTileCols = kQuadCols - 1;
// node rows staged: the quad tile's corners
constexpr int kNodeRows = kQuadRows + 1;
constexpr int kNodeCols = kQuadCols + 1;
// K7: the quad rows of a tile one warp walks, and the warps of its CTA,
// which is one tile
constexpr int kFwdWarpRows = 2;
constexpr int kFwdWarps = (kTileRows + kFwdWarpRows - 1) / kFwdWarpRows;
constexpr int kFwdThreads = 32 * kFwdWarps;

// how each quad picks its diagonal
enum Diag : int { kUp = 0, kDown = 1, kSelMask = 2, kParity = 3 };
// the corner a node occupies in a quad
enum Role : int { kR00 = 0, kR10 = 1, kR11 = 2, kR01 = 3 };
// stencil_vg_kernel's epilogue: the energy and node gradient (K6), or a
// multigrid level step
enum Epi : int {
  kEnergy = 0,
  kMatvec = 1,
  kResidual = 2,
  kStep = 3,
  kFromZero = 4,
  kPostFirst = 5
};
// the bottom kernel: one CTA, at most kBottomLevels levels of at most
// kBottomNodes nodes, each smoothed to a degree of at most kBottomSteps
constexpr int kBottomThreads = 1024;
constexpr int kBottomLevels = 6;
constexpr int kBottomSteps = 32;
constexpr int kBottomNodes = 2304;
constexpr int kBottomQuads = 2048;
// the dynamic shared memory a block may take (227 KB, less the static
// BottomVectors table)
constexpr long long kBottomSmemBytes = 232448 - 256;

struct Lattice {
  const float4* node;  // [nx * ny] rows (cx, cy, ux, uy)
  int nx, ny;
  const float* sel;    // [nx-1, ny-1], read for kSelMask only
  const float* t1;     // [nx-1, ny-1] presence weights (masked kernels)
  const float* t2;
  int phase;           // kParity: quad (i, j) is up iff i + j + phase even
  int row_lo, row_hi;  // the node rows walked (the whole lattice: 0, nx)
};

struct Quad {
  float4 n00, n10, n11, n01;
  bool up;
  float t1, t2;
};

// A level step's vectors, [nx * ny] float2 rows (u, v) unless noted
struct LevelArgs {
  const float2* coords;         // pinned coordinates (cx, cy)
  const unsigned char* pinned;  // 1 on the Dirichlet rows
  const float2* dinv;           // guarded inverse diagonal
  const float2* free;           // 1/0 on the operator's support
  const float2* in;   // the vector the stencil acts on: p, x or d; b for
                      // kFromZero; x before the correction for kPostFirst
  const float2* b;    // the right-hand side
  const float2* r;    // kStep: the residual
  const float2* x;    // kStep: the iterate
  const float2* xc;   // kPostFirst: the coarse iterate [nxc * nyc]
  float2* out_r;      // the new residual (kMatvec: K p)
  float2* out_d;      // the new direction
  float2* out_x;      // the new iterate
  int nyc;
  float c1, c2;       // this step's Chebyshev coefficients
  float inv_theta;    // 1 / theta in float
};

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

// The first owned node (i0, j0) of tile `tile`, the tiles laid from the
// window's first row.
__device__ __forceinline__ void tile_origin(const Lattice& L, int tile,
                                            int* i0, int* j0) {
  const int tiles_j = (L.ny + kTileCols - 1) / kTileCols;
  *i0 = L.row_lo + (tile / tiles_j) * kTileRows;
  *j0 = (tile % tiles_j) * kTileCols;
}

__device__ __forceinline__ bool quad_exists(const Lattice& L, int qi,
                                            int qj) {
  return qi >= 0 && qj >= 0 && qi < L.nx - 1 && qj < L.ny - 1;
}

// diagonal and presence weights of quad (qi, qj), which exists
template <int kDiag, bool kMasked>
__device__ __forceinline__ void quad_flags(const Lattice& L, int qi, int qj,
                                           Quad* Q) {
  const long long q = (long long)qi * (L.ny - 1) + qj;
  if (kDiag == kUp) Q->up = true;
  else if (kDiag == kDown) Q->up = false;
  else if (kDiag == kSelMask) Q->up = __ldg(L.sel + q) > 0.f;
  else Q->up = ((qi + qj + L.phase) & 1) == 0;
  Q->t1 = kMasked ? __ldg(L.t1 + q) : 1.f;
  Q->t2 = kMasked ? __ldg(L.t2 + q) : 1.f;
}

__device__ __forceinline__ float4 shfl4(const float4& v, int lane) {
  return make_float4(__shfl_sync(0xffffffffu, v.x, lane),
                     __shfl_sync(0xffffffffu, v.y, lane),
                     __shfl_sync(0xffffffffu, v.z, lane),
                     __shfl_sync(0xffffffffu, v.w, lane));
}

// 16 B from global to shared memory, asynchronously; zero-filled when
// `valid` is false (src is then not read).
__device__ __forceinline__ void copy16_async(float4* dst, const float4* src,
                                             bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  const size_t g = __cvta_generic_to_global(src);
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(g), "r"(bytes));
}

__device__ __forceinline__ void corner_terms(const Corners& c,
                                             const Material& m, float4* d0,
                                             float4* d1, float4* d2,
                                             float* energy) {
  const hdnn::Strain s = strain(c, m);
  *energy = tri_energy(s, m);
  corner_cotangents(s, m, d0, d1);
  *d2 = make_float4(-(d0->x + d1->x), -(d0->y + d1->y), -(d0->z + d1->z),
                    -(d0->w + d1->w));
}

// g += t * d
__device__ __forceinline__ void add_scaled(float4* g, float t,
                                           const float4& d) {
  g->x += t * d.x;
  g->y += t * d.y;
  g->z += t * d.z;
  g->w += t * d.w;
}

struct Tile {
  float4 node[kNodeRows * kNodeCols];
  float4 cot[6][kThreads];  // T1 corners 0..2, T2 corners 0..2, by quad
  float t1[kThreads], t2[kThreads];
  bool up[kThreads];
};

// node corner kRole of quad slot `q` of the tile: its terms in T1, T2
template <int kRole>
__device__ __forceinline__ void add_quad(const Tile& T, int q, float4* g) {
  const bool up = T.up[q];
  const int s1 = slot1<kRole>(up);
  if (s1 >= 0 && T.t1[q] != 0.f) add_scaled(g, T.t1[q], T.cot[s1][q]);
  const int s2 = slot2<kRole>(up);
  if (s2 >= 0 && T.t2[q] != 0.f) add_scaled(g, T.t2[q], T.cot[3 + s2][q]);
}

// K7: the energy of tile blockIdx.x by kFwdWarps warps, each on
// kFwdWarpRows quad rows of it (rows ty >= 1 of K6's 8 x 32 quad tile),
// lane tx on K6's thread (ty, tx) of each.  Lane tx loads the node column
// of K6's thread tx (lane 0, whose quads K6 does not count, the column
// right of the tile instead) in each node row the rows touch, once: a
// quad's right-hand corners are lane tx + 1's (lane 0's for lane 31), by
// shuffle, and its lower corners are the upper corners of the next quad
// row.  Each quad row is summed by block_sum's warp tree, and the row
// sums are added in row order to 0, as block_sum adds its warps' (its
// warp 0, the halo row, adds +0.0): the tile's partial has K6's bits.
template <int kDiag, bool kMasked>
__global__ void __launch_bounds__(kFwdThreads)
stencil_fwd_kernel(Lattice L, Material m, Tail E) {
  __shared__ float row_sums[kTileRows];
  const int lane = threadIdx.x & 31;
  const int ty0 = 1 + (threadIdx.x >> 5) * kFwdWarpRows;
  const int rows = min(kFwdWarpRows, kQuadRows - ty0);
  // thread 0 stores the tile's partial
  const unsigned int tag = threadIdx.x == 0 ? tail_tag(E) : 0u;
  int i0, j0;
  tile_origin(L, blockIdx.x, &i0, &j0);
  const int col = lane == 0 ? j0 + kTileCols : j0 - 1 + lane;
  const int qj = j0 - 1 + lane;
  // node rows i0 - 1 + ty0 + r, r = 0 .. rows, at column col
  float4 v[kFwdWarpRows + 1];
#pragma unroll
  for (int r = 0; r <= kFwdWarpRows; ++r) {
    const int i = i0 - 1 + ty0 + r;
    v[r] = r <= rows && i < L.nx && col < L.ny
               ? __ldg(L.node + (long long)i * L.ny + col)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int right = (lane + 1) & 31;
  float4 upper = shfl4(v[0], right);
#pragma unroll
  for (int r = 1; r <= kFwdWarpRows; ++r) {
    if (r > rows) break;
    const int ty = ty0 + r - 1;
    const int qi = i0 - 1 + ty;
    const float4 lower = shfl4(v[r], right);
    float acc = 0.f;
    if (lane >= 1 && qi < L.row_hi && quad_exists(L, qi, qj)) {
      Quad Q;
      Q.n00 = v[r - 1];
      Q.n01 = upper;
      Q.n10 = v[r];
      Q.n11 = lower;
      quad_flags<kDiag, kMasked>(L, qi, qj, &Q);
      acc = quad_energy(Q, m);
    }
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) row_sums[ty - 1] = acc;
    upper = lower;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int ty = 1; ty < kQuadRows; ++ty) total += row_sums[ty - 1];
    tail_put(E, tag, blockIdx.x, total);
  }
  tail_finish<kFwdThreads>(E);
}

// ------------------------------------------------------ level steps
// elementwise, each product and sum rounded alone (no contraction)
__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}

__device__ __forceinline__ float2 sub2(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}

__device__ __forceinline__ float2 mul2(float2 a, float2 b) {
  return make_float2(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y));
}

__device__ __forceinline__ float2 scale2(float s, float2 a) {
  return make_float2(__fmul_rn(s, a.x), __fmul_rn(s, a.y));
}

// 0.5 * (a + b)
__device__ __forceinline__ float2 mid2(float2 a, float2 b) {
  return scale2(0.5f, add2(a, b));
}

// (dinv * r) / theta, the first Chebyshev direction
__device__ __forceinline__ float2 first_direction(const LevelArgs& A,
                                                  float2 dinv, float2 r) {
  return scale2(A.inv_theta, mul2(dinv, r));
}

// c1 d + c2 (dinv * r)
__device__ __forceinline__ float2 next_direction(const LevelArgs& A,
                                                 float2 dinv, float2 d,
                                                 float2 r) {
  return add2(scale2(A.c1, d), scale2(A.c2, mul2(dinv, r)));
}

// prolong(xc) at fine node (i, j): the row pass, then the column pass
__device__ __forceinline__ float2 prolong_row(const float2* xc, int nyc,
                                              int i, int J) {
  const float2 a = xc[(long long)(i >> 1) * nyc + J];
  return (i & 1) ? mid2(a, xc[(long long)((i >> 1) + 1) * nyc + J]) : a;
}

__device__ __forceinline__ float2 prolonged(const float2* xc, int nyc,
                                            int i, int j) {
  const float2 v = prolong_row(xc, nyc, i, j >> 1);
  return (j & 1) ? mid2(v, prolong_row(xc, nyc, i, (j >> 1) + 1)) : v;
}

// x + free * prolong(xc) at node n = (i, j)
__device__ __forceinline__ float2 corrected(const LevelArgs& A, int i,
                                            int j, long long n) {
  return add2(A.in[n],
              mul2(__ldg(A.free + n), prolonged(A.xc, A.nyc, i, j)));
}

// the displacement the stencil sees at node n = (i, j): 0 on a Dirichlet
// row, as the level operator pins it
template <int kEpi>
__device__ __forceinline__ float2 staged(const LevelArgs& A, int i, int j,
                                         long long n) {
  if (__ldg(A.pinned + n)) return make_float2(0.f, 0.f);
  if (kEpi == kFromZero)
    return first_direction(A, __ldg(A.dinv + n), A.in[n]);
  if (kEpi == kPostFirst) return corrected(A, i, j, n);
  return A.in[n];
}

// What node n = (i, j)'s update reads besides K (staged vector): loaded
// before the stencil, so that the loads overlap it
struct NodeIn {
  float2 a;     // b (kResidual, kFromZero, kPostFirst), r (kStep)
  float2 v;     // d (kStep), the corrected x (kPostFirst)
  float2 x;     // x (kStep)
  float2 dinv;  // (kStep, kFromZero, kPostFirst)
  bool pinned;
};

template <int kEpi>
__device__ __forceinline__ NodeIn node_in(const LevelArgs& A, int i, int j,
                                          long long n) {
  NodeIn u{};
  u.pinned = __ldg(A.pinned + n);
  if (kEpi == kResidual || kEpi == kPostFirst) u.a = A.b[n];
  if (kEpi == kFromZero) u.a = A.in[n];
  if (kEpi == kStep) {
    u.a = A.r[n];
    u.v = A.in[n];
    u.x = A.x[n];
  }
  if (kEpi == kPostFirst) u.v = corrected(A, i, j, n);
  if (kEpi >= kStep) u.dinv = __ldg(A.dinv + n);
  return u;
}

// node n's vectors from its inputs u and g = K (staged vector) at n (w:
// 0 on a Dirichlet row)
template <int kEpi>
__device__ __forceinline__ void level_update(const LevelArgs& A, long long n,
                                             const NodeIn& u, float2 g) {
  const float2 w = u.pinned ? make_float2(0.f, 0.f) : g;
  if (kEpi == kMatvec) {
    A.out_r[n] = w;
  } else if (kEpi == kResidual) {
    A.out_r[n] = sub2(u.a, w);
  } else if (kEpi == kStep) {
    const float2 r = sub2(u.a, w);
    const float2 d = next_direction(A, u.dinv, u.v, r);
    A.out_r[n] = r;
    A.out_d[n] = d;
    A.out_x[n] = add2(u.x, d);
  } else if (kEpi == kFromZero) {
    // r0 = b - K 0 = b, d0 = dinv r0 / theta, x0 = 0 + d0; then the step
    const float2 d0 = first_direction(A, u.dinv, u.a);
    const float2 x0 = add2(make_float2(0.f, 0.f), d0);
    const float2 r = sub2(u.a, w);
    const float2 d = next_direction(A, u.dinv, d0, r);
    A.out_r[n] = r;
    A.out_d[n] = d;
    A.out_x[n] = add2(x0, d);
  } else {  // kPostFirst
    const float2 r = sub2(u.a, w);
    const float2 d = first_direction(A, u.dinv, r);
    A.out_r[n] = r;
    A.out_d[n] = d;
    A.out_x[n] = add2(u.v, d);
  }
}

// the displacement part of corner_terms: K6's strain and cotangent code,
// whose coordinate part and energy the compiler drops
__device__ __forceinline__ void corner_terms_u(const Corners& c,
                                               const Material& m, float2* d0,
                                               float2* d1, float2* d2) {
  const hdnn::Strain s = strain(c, m);
  float4 c0, c1;
  corner_cotangents(s, m, &c0, &c1);
  *d0 = make_float2(c0.z, c0.w);
  *d1 = make_float2(c1.z, c1.w);
  *d2 = make_float2(-(c0.z + c1.z), -(c0.w + c1.w));
}

__device__ __forceinline__ float4 node4(float2 c, float2 u) {
  return make_float4(c.x, c.y, u.x, u.y);
}

// g += t * d, as add_scaled does it for the displacement columns
__device__ __forceinline__ void add_scaled2(float2* g, float t,
                                            const float2& d) {
  g->x += t * d.x;
  g->y += t * d.y;
}

// node corner kRole of a quad whose flags and corner terms (by slot,
// T1's then T2's) are given: its terms in T1, T2
template <int kRole>
__device__ __forceinline__ void add_quad_u(bool up, float t1, float t2,
                                           const float2* cot, int stride,
                                           float2* g) {
  const int s1 = slot1<kRole>(up);
  if (s1 >= 0 && t1 != 0.f) add_scaled2(g, t1, cot[s1 * stride]);
  const int s2 = slot2<kRole>(up);
  if (s2 >= 0 && t2 != 0.f) add_scaled2(g, t2, cot[(3 + s2) * stride]);
}

// quad Q's corner terms into cot[slot * stride]
__device__ __forceinline__ void quad_terms_u(const Quad& Q,
                                             const Material& m, float2* cot,
                                             int stride) {
  if (Q.t1 != 0.f)
    corner_terms_u(tri1(Q), m, &cot[0], &cot[stride], &cot[2 * stride]);
  if (Q.t2 != 0.f)
    corner_terms_u(tri2(Q), m, &cot[3 * stride], &cot[4 * stride],
                   &cot[5 * stride]);
}

struct LevelTile {
  float2 c[kNodeRows * kNodeCols];  // coordinates
  float2 u[kNodeRows * kNodeCols];  // the staged displacement
  float2 cot[6][kThreads];
  float t1[kThreads], t2[kThreads];
  bool up[kThreads];
};

// A level step on tile blockIdx.x of the whole lattice: K6's tile, quad
// of each thread and gather order, on the staged vector.
template <int kDiag, bool kMasked, int kEpi>
__device__ __forceinline__ void level_tile(const Lattice& L,
                                           const Material& m,
                                           const LevelArgs& A) {
  __shared__ LevelTile T;
  int i0, j0;
  tile_origin(L, blockIdx.x, &i0, &j0);
  for (int k = threadIdx.x; k < kNodeRows * kNodeCols; k += kThreads) {
    const int i = i0 - 1 + k / kNodeCols, j = j0 - 1 + k % kNodeCols;
    const bool valid = i >= 0 && j >= 0 && i < L.nx && j < L.ny;
    const long long n = (long long)i * L.ny + j;
    T.c[k] = valid ? __ldg(A.coords + n) : make_float2(0.f, 0.f);
    T.u[k] = valid ? staged<kEpi>(A, i, j, n) : make_float2(0.f, 0.f);
  }
  const int ty = threadIdx.x / kQuadCols, tx = threadIdx.x % kQuadCols;
  const int qi = i0 - 1 + ty, qj = j0 - 1 + tx;
  const bool exists = quad_exists(L, qi, qj);
  Quad Q;
  quad_flags<kDiag, kMasked>(L, exists ? qi : 0, exists ? qj : 0, &Q);
  if (!exists) Q.t1 = Q.t2 = 0.f;
  // the node (qi, qj) this thread updates, and its inputs
  const bool owner = ty >= 1 && tx >= 1 && qi < L.nx && qj < L.ny;
  const long long n = (long long)qi * L.ny + qj;
  NodeIn u{};
  if (owner) u = node_in<kEpi>(A, qi, qj, n);
  __syncthreads();

  const int b = ty * kNodeCols + tx;
  Q.n00 = node4(T.c[b], T.u[b]);
  Q.n01 = node4(T.c[b + 1], T.u[b + 1]);
  Q.n10 = node4(T.c[b + kNodeCols], T.u[b + kNodeCols]);
  Q.n11 = node4(T.c[b + kNodeCols + 1], T.u[b + kNodeCols + 1]);
  const int q = threadIdx.x;
  quad_terms_u(Q, m, &T.cot[0][q], kThreads);
  T.t1[q] = Q.t1;
  T.t2[q] = Q.t2;
  T.up[q] = Q.up;
  __syncthreads();

  if (owner) {
    float2 g = make_float2(0.f, 0.f);
#define HDNN_QUAD(role, p) \
  add_quad_u<role>(T.up[p], T.t1[p], T.t2[p], &T.cot[0][p], kThreads, &g)
    HDNN_QUAD(kR11, q - kQuadCols - 1);
    HDNN_QUAD(kR10, q - kQuadCols);
    HDNN_QUAD(kR01, q - 1);
    HDNN_QUAD(kR00, q);
#undef HDNN_QUAD
    level_update<kEpi>(A, n, u, g);
  }
}

// coarse entry (I, J) of full-weighting restriction of r [nx, ny] (the
// transpose of prolong): the column pass, then the row pass, each adding
// in _restrict_axis's order: (h[J - 1], or 0 at J = 0, + h[J]) + r[2 J]
__device__ __forceinline__ float2 restrict_cols(const float2* row, int nc,
                                                int J) {
  float2 o = J >= 1 ? scale2(0.5f, row[2 * J - 1]) : make_float2(0.f, 0.f);
  if (J < nc - 1) o = add2(o, scale2(0.5f, row[2 * J + 1]));
  return add2(o, row[2 * J]);
}

__device__ __forceinline__ float2 restricted(const float2* r, int nx, int ny,
                                             int I, int J) {
  const int nr = (nx + 1) / 2, nc = (ny + 1) / 2;
  auto col = [&](int i) { return restrict_cols(r + (long long)i * ny, nc, J); };
  float2 o = I >= 1 ? scale2(0.5f, col(2 * I - 1)) : make_float2(0.f, 0.f);
  if (I < nr - 1) o = add2(o, scale2(0.5f, col(2 * I + 1)));
  return add2(o, col(2 * I));
}

__global__ void __launch_bounds__(kThreads)
restrict_kernel(const float2* __restrict__ r, int nx, int ny,
                float2* __restrict__ out) {
  const int nyc = (ny + 1) / 2;
  const long long n = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (n >= (long long)((nx + 1) / 2) * nyc) return;
  out[n] = restricted(r, nx, ny, (int)(n / nyc), (int)(n % nyc));
}

// --------------------------------------------------- the bottom levels
struct BottomLevel {
  const float2* coords;
  const unsigned char* pinned;
  const float2* dinv;
  const float2* free;
  const float* t1;
  const float* t2;
  const float2* b;  // level 0: the right-hand side
  float2* x;        // level 0: the answer
  int nx, ny, phase, degree;
  float inv_theta;
  float c1[kBottomSteps - 1], c2[kBottomSteps - 1];
};

struct Bottom {
  BottomLevel lev[kBottomLevels];
  int n;
};

// The bottom kernel's dynamic shared memory: this, then the levels'
// vectors (bottom_vectors), all but level 0's b and answer
struct BottomSmem {
  float2 s[kBottomNodes];  // the staged vector
  float2 cot[6][kBottomQuads];
  float t1[kBottomQuads], t2[kBottomQuads];
  bool up[kBottomQuads];
};

// b, x, r, d of each level
struct BottomVectors {
  float2* v[kBottomLevels][4];
};

// the shared-memory floats the levels' vectors take after BottomSmem:
// level 0's x, r, d, and b, x, r, d of every level below it
inline long long bottom_vector_floats(const Bottom& B) {
  long long n = 0;
  for (int l = 0; l < B.n; ++l)
    n += (l ? 4LL : 3LL) * 2 * B.lev[l].nx * B.lev[l].ny;
  return n;
}

// One step of kind kEpi over a whole bottom level: stage, the quads'
// corner terms, each node's gather and update; a block barrier after each.
// A step that writes a new direction stages it (0 on a Dirichlet row) for
// the next pass, a Chebyshev step (kStep), which therefore stages nothing.
template <int kDiag, bool kMasked, int kEpi>
__device__ void bottom_pass(const BottomLevel& V, const Material& m,
                            const LevelArgs& A, BottomSmem& S) {
  const Lattice L{nullptr, V.nx, V.ny, nullptr, V.t1, V.t2, V.phase, 0,
                  V.nx};
  const int nodes = V.nx * V.ny, qn = V.ny - 1, quads = (V.nx - 1) * qn;
  if (kEpi != kStep) {
    for (int n = threadIdx.x; n < nodes; n += kBottomThreads)
      S.s[n] = staged<kEpi>(A, n / V.ny, n % V.ny, n);
    __syncthreads();
  }
  for (int q = threadIdx.x; q < quads; q += kBottomThreads) {
    const int qi = q / qn, qj = q % qn, n00 = qi * V.ny + qj;
    Quad Q;
    quad_flags<kDiag, kMasked>(L, qi, qj, &Q);
    Q.n00 = node4(__ldg(A.coords + n00), S.s[n00]);
    Q.n01 = node4(__ldg(A.coords + n00 + 1), S.s[n00 + 1]);
    Q.n10 = node4(__ldg(A.coords + n00 + V.ny), S.s[n00 + V.ny]);
    Q.n11 = node4(__ldg(A.coords + n00 + V.ny + 1), S.s[n00 + V.ny + 1]);
    quad_terms_u(Q, m, &S.cot[0][q], kBottomQuads);
    S.t1[q] = Q.t1;
    S.t2[q] = Q.t2;
    S.up[q] = Q.up;
  }
  __syncthreads();
  for (int n = threadIdx.x; n < nodes; n += kBottomThreads) {
    const int i = n / V.ny, j = n % V.ny;
    float2 g = make_float2(0.f, 0.f);
#define HDNN_QUAD(role, p) \
  add_quad_u<role>(S.up[p], S.t1[p], S.t2[p], &S.cot[0][p], kBottomQuads, &g)
    if (i >= 1 && j >= 1) HDNN_QUAD(kR11, (i - 1) * qn + j - 1);
    if (i >= 1 && j < qn) HDNN_QUAD(kR10, (i - 1) * qn + j);
    if (i < V.nx - 1 && j >= 1) HDNN_QUAD(kR01, i * qn + j - 1);
    if (i < V.nx - 1 && j < qn) HDNN_QUAD(kR00, i * qn + j);
#undef HDNN_QUAD
    const NodeIn u = node_in<kEpi>(A, i, j, n);
    level_update<kEpi>(A, n, u, g);
    if (kEpi >= kStep)
      S.s[n] = u.pinned ? make_float2(0.f, 0.f) : A.out_d[n];
  }
  __syncthreads();
}

// level V's steps on its vectors v = (b, x, r, d), updated in place
__device__ __forceinline__ LevelArgs bottom_args(const BottomLevel& V,
                                                 float2* const* v) {
  LevelArgs A{};
  A.coords = V.coords;
  A.pinned = V.pinned;
  A.dinv = V.dinv;
  A.free = V.free;
  A.b = v[0];
  A.r = v[2];
  A.x = v[1];
  A.out_r = v[2];
  A.out_d = v[3];
  A.out_x = v[1];
  A.inv_theta = V.inv_theta;
  return A;
}

// The Chebyshev steps k0 .. degree - 2 on level V (in place)
template <int kDiag, bool kMasked>
__device__ void bottom_steps(const BottomLevel& V, float2* const* v,
                             const Material& m, int k0, BottomSmem& S) {
  LevelArgs A = bottom_args(V, v);
  A.in = v[3];
  for (int k = k0; k < V.degree - 1; ++k) {
    A.c1 = V.c1[k];
    A.c2 = V.c2[k];
    bottom_pass<kDiag, kMasked, kStep>(V, m, A, S);
  }
}

// V(nu, nu) from B.lev[0] down to the coarsest and back, in one CTA:
// each level's smoothing from 0 (kFromZero with its first coefficients,
// then the rest), its residual and the restriction into the next level's
// b; the coarsest smoothed alone; then each level's prolonged correction
// with the first post-smoothing step, and the rest.  Every vector but
// level 0's b lives in shared memory, so a pass reads global memory only
// for the read-only tables (coordinates, pins, dinv, free, weights: L1);
// the answer, level 0's x, is copied out at the end.
template <int kDiag, bool kMasked>
__global__ void __launch_bounds__(kBottomThreads)
level_bottom_kernel(const __grid_constant__ Bottom B, Material m) {
  extern __shared__ __align__(16) unsigned char smem[];
  BottomSmem& S = *reinterpret_cast<BottomSmem*>(smem);
  __shared__ BottomVectors P;
  if (threadIdx.x == 0) {
    float2* p = reinterpret_cast<float2*>(smem + sizeof(BottomSmem));
    for (int l = 0; l < B.n; ++l) {
      const int n = B.lev[l].nx * B.lev[l].ny;
      P.v[l][0] = l ? p : const_cast<float2*>(B.lev[0].b);
      if (l) p += n;
      for (int k = 1; k < 4; ++k, p += n) P.v[l][k] = p;
    }
  }
  __syncthreads();
  for (int l = 0; l < B.n; ++l) {
    const BottomLevel& V = B.lev[l];
    float2* const* v = P.v[l];
    LevelArgs A = bottom_args(V, v);
    A.in = v[0];
    A.c1 = V.c1[0];
    A.c2 = V.c2[0];
    bottom_pass<kDiag, kMasked, kFromZero>(V, m, A, S);
    bottom_steps<kDiag, kMasked>(V, v, m, 1, S);
    if (l == B.n - 1) break;
    A.in = v[1];
    bottom_pass<kDiag, kMasked, kResidual>(V, m, A, S);
    const BottomLevel& C = B.lev[l + 1];
    for (int n = threadIdx.x; n < C.nx * C.ny; n += kBottomThreads)
      P.v[l + 1][0][n] = restricted(v[2], V.nx, V.ny, n / C.ny, n % C.ny);
    __syncthreads();
  }
  for (int l = B.n - 2; l >= 0; --l) {
    const BottomLevel& V = B.lev[l];
    float2* const* v = P.v[l];
    LevelArgs A = bottom_args(V, v);
    A.in = v[1];
    A.xc = P.v[l + 1][1];
    A.nyc = B.lev[l + 1].ny;
    bottom_pass<kDiag, kMasked, kPostFirst>(V, m, A, S);
    bottom_steps<kDiag, kMasked>(V, v, m, 0, S);
  }
  for (int n = threadIdx.x; n < B.lev[0].nx * B.lev[0].ny;
       n += kBottomThreads)
    B.lev[0].x[n] = P.v[0][1][n];
}

// K6: the tile's quads evaluated once each into shared memory, then the
// gradient of each owned node gathered from its <= 4 quads; CTAs past the
// E.n tiles write the zero rows outside the window.  With kEpi !=
// kEnergy, a multigrid level step (level_tile) on LevelArgs A instead;
// the energy kernels take an empty A and never read it.
template <int kDiag, bool kMasked, int kEpi = kEnergy>
__global__ void __launch_bounds__(kThreads)
stencil_vg_kernel(Lattice L, Material m, float4* __restrict__ grad,
                  Tail E, LevelArgs A) {
  if constexpr (kEpi != kEnergy) {
    level_tile<kDiag, kMasked, kEpi>(L, m, A);
  } else {
    __shared__ Tile T;
    if ((int)blockIdx.x >= E.n) {
      zero_rows_outside<kThreads>(grad, (long long)L.nx * L.ny,
                                  (long long)L.row_lo * L.ny,
                                  (long long)L.row_hi * L.ny,
                                  blockIdx.x - E.n);
      energy_tail<kThreads>(0.f, -1, 0u, E);
      return;
    }
    const unsigned int tag = threadIdx.x == 0 ? tail_tag(E) : 0u;
    int i0, j0;
    tile_origin(L, blockIdx.x, &i0, &j0);
    // stage the node rows (i0 - 1 .. i0 + 7) x (j0 - 1 .. j0 + 31)
    for (int k = threadIdx.x; k < kNodeRows * kNodeCols; k += kThreads) {
      const int i = i0 - 1 + k / kNodeCols, j = j0 - 1 + k % kNodeCols;
      const bool valid = i >= 0 && j >= 0 && i < L.nx && j < L.ny;
      copy16_async(&T.node[k],
                   L.node + (valid ? (long long)i * L.ny + j : 0LL), valid);
    }
    const int ty = threadIdx.x / kQuadCols, tx = threadIdx.x % kQuadCols;
    const int qi = i0 - 1 + ty, qj = j0 - 1 + tx;
    // A quad off the lattice reads quad (0, 0)'s flags and adds nothing.
    // Unmasked weights stay the constant 1, so that the energy below folds
    // t * E to E and compiles to the same arithmetic as K7's quad_energy
    // (a runtime weight of 1 would round t * E before adding it, where
    // K7's fused multiply-add does not).
    const bool exists = quad_exists(L, qi, qj);
    Quad Q;
    quad_flags<kDiag, kMasked>(L, exists ? qi : 0, exists ? qj : 0, &Q);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();

    // this thread's quad, once
    const int b = ty * kNodeCols + tx;
    Q.n00 = T.node[b];
    Q.n01 = T.node[b + 1];
    Q.n10 = T.node[b + kNodeCols];
    Q.n11 = T.node[b + kNodeCols + 1];
    const int q = threadIdx.x;
    float e = 0.f, et;
    if (exists && Q.t1 != 0.f) {
      corner_terms(tri1(Q), m, &T.cot[0][q], &T.cot[1][q], &T.cot[2][q], &et);
      e += Q.t1 * et;
    }
    if (exists && Q.t2 != 0.f) {
      corner_terms(tri2(Q), m, &T.cot[3][q], &T.cot[4][q], &T.cot[5][q], &et);
      e += Q.t2 * et;
    }
    T.t1[q] = exists ? Q.t1 : 0.f;
    T.t2[q] = exists ? Q.t2 : 0.f;
    T.up[q] = Q.up;
    // the node (qi, qj) of this thread, when it lies in the window
    const bool owner = ty >= 1 && tx >= 1 && qi < L.row_hi;
    const float acc = owner ? e : 0.f;
    __syncthreads();

    // node (qi, qj): corner n11 of quad q - 33, n10 of q - 32, n01 of
    // q - 1, n00 of q
    if (owner && qi < L.nx && qj < L.ny) {
      float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
      add_quad<kR11>(T, q - kQuadCols - 1, &g);
      add_quad<kR10>(T, q - kQuadCols, &g);
      add_quad<kR01>(T, q - 1, &g);
      add_quad<kR00>(T, q, &g);
      grad[(long long)qi * L.ny + qj] = g;
    }
    const float total = block_sum<float, kThreads / 32>(acc);
    energy_tail<kThreads>(total, blockIdx.x, tag, E);
  }
}

// One launch: the E.n tiles (and, for K6, the `zeros` zero CTAs after
// them).
template <int kDiag, bool kMasked>
cudaError_t launch(bool vg, const Lattice& L, const Material& m,
                   float4* grad, const Tail& E, long long zeros,
                   cudaStream_t st) {
  if (vg) {
    stencil_vg_kernel<kDiag, kMasked>
        <<<(unsigned)(E.n + zeros), kThreads, 0, st>>>(L, m, grad, E,
                                                      LevelArgs{});
  } else {
    stencil_fwd_kernel<kDiag, kMasked>
        <<<E.n, kFwdThreads, 0, st>>>(L, m, E);
  }
  return cudaGetLastError();
}

template <int kDiag>
cudaError_t launch_masked(bool vg, const Lattice& L, const Material& m,
                          float4* grad, const Tail& E, long long zeros,
                          cudaStream_t st) {
  if (L.t1 != nullptr)
    return launch<kDiag, true>(vg, L, m, grad, E, zeros, st);
  return launch<kDiag, false>(vg, L, m, grad, E, zeros, st);
}

// the tiles (energy partials) of a window of nx rows of a lattice ny wide
int n_tiles(int nx, int ny) {
  return ((nx + kTileRows - 1) / kTileRows) *
         ((ny + kTileCols - 1) / kTileCols);
}

__global__ void empty_kernel() {}

int run(int device, bool vg, const void* node, int nx, int ny, int row_lo,
        int row_hi, int diag, int phase, const void* sel, const void* t1,
        const void* t2, float f, float nu, float shear, float w_sum,
        void* grad, void* out, void* stream) {
  if (row_lo < 0 || row_lo >= row_hi || row_hi > nx)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  // K6's zero CTAs after its tiles (none for K7 or the whole lattice)
  const int tiles = n_tiles(row_hi - row_lo, ny);
  const long long zeros =
      vg ? zero_blocks<kThreads>((long long)(nx - (row_hi - row_lo)) * ny)
         : 0;
  Tail E = hdnn::make_tail(tiles, tiles + zeros, false, (float*)out);
  const int got = hdnn::tail_slot(device, st, &E);
  if (got != (int)cudaSuccess) return got;
  const Lattice L{(const float4*)node, nx, ny, (const float*)sel,
                  (const float*)t1, (const float*)t2, phase, row_lo, row_hi};
  const Material m = material(f, nu, shear, w_sum);
  float4* g = (float4*)grad;
  switch (diag) {
    case kUp:
      return (int)launch_masked<kUp>(vg, L, m, g, E, zeros, st);
    case kDown:
      return (int)launch_masked<kDown>(vg, L, m, g, E, zeros, st);
    case kSelMask:
      return (int)launch_masked<kSelMask>(vg, L, m, g, E, zeros, st);
    case kParity:
      return (int)launch_masked<kParity>(vg, L, m, g, E, zeros, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// A level step (kEpi) on the whole lattice: one tile a CTA.  The level
// operators are structured-grid levels: their quad mask is both triangle
// weights, and the diagonal is uniform or the zigzag parity.
template <int kDiag, int kEpi>
cudaError_t launch_level(const Lattice& L, const Material& m,
                         const LevelArgs& A, cudaStream_t st) {
  stencil_vg_kernel<kDiag, true, kEpi>
      <<<n_tiles(L.nx, L.ny), kThreads, 0, st>>>(L, m, nullptr, Tail{}, A);
  return cudaGetLastError();
}

template <int kDiag>
cudaError_t launch_level_epi(int epi, const Lattice& L, const Material& m,
                             const LevelArgs& A, cudaStream_t st) {
  switch (epi) {
    case kMatvec:
      return launch_level<kDiag, kMatvec>(L, m, A, st);
    case kResidual:
      return launch_level<kDiag, kResidual>(L, m, A, st);
    case kStep:
      return launch_level<kDiag, kStep>(L, m, A, st);
    case kFromZero:
      return launch_level<kDiag, kFromZero>(L, m, A, st);
    case kPostFirst:
      return launch_level<kDiag, kPostFirst>(L, m, A, st);
    default:
      return cudaErrorInvalidValue;
  }
}

template <int kDiag>
cudaError_t launch_bottom(const Bottom& B, const Material& m,
                          cudaStream_t st) {
  const long long bytes =
      (long long)sizeof(BottomSmem) + 4 * bottom_vector_floats(B);
  if (bytes > kBottomSmemBytes) return cudaErrorInvalidValue;
  const cudaError_t attr = cudaFuncSetAttribute(
      level_bottom_kernel<kDiag, true>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (attr != cudaSuccess) return attr;
  level_bottom_kernel<kDiag, true>
      <<<1, kBottomThreads, (size_t)bytes, st>>>(B, m);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K7: the energy of the lattice into *out (device float).  diag: 0 up,
// 1 down, 2 per-quad sel mask, 3 zigzag parity with `phase`; t1 == NULL
// means every triangle is present.  One launch; returns
// cudaGetLastError() after it (or the error of taking its tail slot).
int hdnn_lattice_stencil_fwd(int device, const void* node, int nx, int ny,
                             int diag, int phase, const void* sel,
                             const void* t1, const void* t2, float f,
                             float nu, float shear, float w_sum, void* out,
                             void* stream) {
  return run(device, false, node, nx, ny, 0, nx, diag, phase, sel, t1, t2,
             f, nu, shear, w_sum, nullptr, out, stream);
}

// K6: as K7, and the node gradient [nx * ny, 4] (float4 rows) into grad,
// in the same launch.
int hdnn_lattice_stencil_vg(int device, const void* node, int nx, int ny,
                            int diag, int phase, const void* sel,
                            const void* t1, const void* t2, float f,
                            float nu, float shear, float w_sum, void* grad,
                            void* out, void* stream) {
  return run(device, true, node, nx, ny, 0, nx, diag, phase, sel, t1, t2,
             f, nu, shear, w_sum, grad, out, stream);
}

// K7 over the node rows [row_lo, row_hi) of the lattice (0 <= row_lo <
// row_hi <= nx): the energy of the quads whose n00 row lies there.
int hdnn_lattice_stencil_fwd_rows(int device, const void* node, int nx,
                                  int ny, int row_lo, int row_hi, int diag,
                                  int phase, const void* sel, const void* t1,
                                  const void* t2, float f, float nu,
                                  float shear, float w_sum, void* out,
                                  void* stream) {
  return run(device, false, node, nx, ny, row_lo, row_hi, diag, phase, sel,
             t1, t2, f, nu, shear, w_sum, nullptr, out, stream);
}

// K6 over the node rows [row_lo, row_hi): that energy, and grad
// [nx * ny, 4] whole: the gradient of the window's nodes in their rows,
// +0.0 in every other row (whatever grad held before), in one launch.
int hdnn_lattice_stencil_vg_rows(int device, const void* node, int nx,
                                 int ny, int row_lo, int row_hi, int diag,
                                 int phase, const void* sel, const void* t1,
                                 const void* t2, float f, float nu,
                                 float shear, float w_sum, void* grad,
                                 void* out, void* stream) {
  return run(device, true, node, nx, ny, row_lo, row_hi, diag, phase, sel,
             t1, t2, f, nu, shear, w_sum, grad, out, stream);
}

// An empty kernel with K7's grid and blocks over a window of nx rows of a
// lattice ny wide: the fixed cost of such a launch (a measurement; no
// path runs it).
int hdnn_lattice_launch_floor(int device, int nx, int ny, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  empty_kernel<<<n_tiles(nx, ny), kFwdThreads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

// A multigrid level step on the whole nx-by-ny lattice in one launch
// (module comment): epi 1 K p into out_r, 2 the residual b - K x into
// out_r, 3 a Chebyshev step (in = d, r, x), 4 the first two steps from
// x = 0 (in = b), 5 the prolonged correction x + free prolong(xc) and the
// post-smoother's first step (in = x, xc [nxc, nyc]); 3-5 write out_r,
// out_d and out_x.  Every vector is [nx * ny] float2; pinned [nx * ny]
// bytes; t1 = t2 the [nx-1, ny-1] quad weights.  diag: 0 up, 1 down, 3
// the zigzag parity with `phase`.  No output may alias an input, but for
// kStep's out_r = r and out_x = x (a node reads and writes only its own).
int hdnn_lattice_level_step(int device, int epi, int nx, int ny, int diag,
                            int phase, const void* t1, const void* t2,
                            float f, float nu, float shear, float w_sum,
                            const void* coords, const void* pinned,
                            const void* dinv, const void* free,
                            const void* in, const void* b, const void* r,
                            const void* x, const void* xc, int nyc,
                            void* out_r, void* out_d, void* out_x, float c1,
                            float c2, float inv_theta, void* stream) {
  if (nx < 2 || ny < 2 || t1 == nullptr || t2 == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Lattice L{nullptr, nx, ny, nullptr, (const float*)t1,
                  (const float*)t2, phase, 0, nx};
  const LevelArgs A{(const float2*)coords, (const unsigned char*)pinned,
                    (const float2*)dinv, (const float2*)free,
                    (const float2*)in, (const float2*)b, (const float2*)r,
                    (const float2*)x, (const float2*)xc, (float2*)out_r,
                    (float2*)out_d, (float2*)out_x, nyc, c1, c2, inv_theta};
  const Material m = material(f, nu, shear, w_sum);
  cudaStream_t st = (cudaStream_t)stream;
  switch (diag) {
    case kUp:
      return (int)launch_level_epi<kUp>(epi, L, m, A, st);
    case kDown:
      return (int)launch_level_epi<kDown>(epi, L, m, A, st);
    case kParity:
      return (int)launch_level_epi<kParity>(epi, L, m, A, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Full-weighting restriction of r [nx, ny] float2 (nx, ny odd) into out
// [(nx + 1) / 2, (ny + 1) / 2], in one launch.
int hdnn_lattice_restrict(int device, int nx, int ny, const void* r,
                          void* out, void* stream) {
  if (nx < 3 || ny < 3 || nx % 2 == 0 || ny % 2 == 0)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)((nx + 1) / 2) * ((ny + 1) / 2);
  restrict_kernel<<<(unsigned)((n + kThreads - 1) / kThreads), kThreads, 0,
                    (cudaStream_t)stream>>>((const float2*)r, nx, ny,
                                            (float2*)out);
  return (int)cudaGetLastError();
}

// The bottom levels' V-cycle in one CTA (level_bottom_kernel).  Level l
// of n_levels (finest first) is ptrs[8 l ..] = coords, pinned, dinv,
// free, t1, t2, b, x; ints[4 l ..] = nx, ny, phase, degree;
// coefs[(1 + 2 (kBottomSteps - 1)) l ..] = 1 / theta, c1[kBottomSteps - 1],
// c2[kBottomSteps - 1].  Level 0's b is the right-hand side and its x the
// answer (the other levels' b and x are not read); every other vector
// lives in the kernel's shared memory.
int hdnn_lattice_bottom(int device, int n_levels, int diag, float f,
                        float nu, float shear, float w_sum,
                        const unsigned long long* ptrs, const int* ints,
                        const float* coefs, void* stream) {
  if (n_levels < 1 || n_levels > kBottomLevels)
    return (int)cudaErrorInvalidValue;
  Bottom B{};
  B.n = n_levels;
  for (int l = 0; l < n_levels; ++l) {
    BottomLevel& V = B.lev[l];
    const unsigned long long* p = ptrs + 8 * l;
    V.coords = (const float2*)p[0];
    V.pinned = (const unsigned char*)p[1];
    V.dinv = (const float2*)p[2];
    V.free = (const float2*)p[3];
    V.t1 = (const float*)p[4];
    V.t2 = (const float*)p[5];
    V.b = (const float2*)p[6];
    V.x = (float2*)p[7];
    V.nx = ints[4 * l];
    V.ny = ints[4 * l + 1];
    V.phase = ints[4 * l + 2];
    V.degree = ints[4 * l + 3];
    if (V.nx < 2 || V.ny < 2 || V.nx * V.ny > kBottomNodes ||
        (V.nx - 1) * (V.ny - 1) > kBottomQuads || V.degree < 2 ||
        V.degree > kBottomSteps)
      return (int)cudaErrorInvalidValue;
    const float* c = coefs + (1 + 2 * (kBottomSteps - 1)) * l;
    V.inv_theta = c[0];
    for (int k = 0; k < kBottomSteps - 1; ++k) {
      V.c1[k] = c[1 + k];
      V.c2[k] = c[kBottomSteps + k];
    }
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Material m = material(f, nu, shear, w_sum);
  cudaStream_t st = (cudaStream_t)stream;
  switch (diag) {
    case kUp:
      return (int)launch_bottom<kUp>(B, m, st);
    case kDown:
      return (int)launch_bottom<kDown>(B, m, st);
    case kParity:
      return (int)launch_bottom<kParity>(B, m, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* hdnn_error_string(int err) { return hdnn::error_string(err); }

}  // extern "C"
