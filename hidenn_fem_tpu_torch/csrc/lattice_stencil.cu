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

// K6: the tile's quads evaluated once each into shared memory, then the
// gradient of each owned node gathered from its <= 4 quads; CTAs past the
// E.n tiles write the zero rows outside the window.
template <int kDiag, bool kMasked>
__global__ void __launch_bounds__(kThreads)
stencil_vg_kernel(Lattice L, Material m, float4* __restrict__ grad,
                  Tail E) {
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

// One launch: the E.n tiles (and, for K6, the `zeros` zero CTAs after
// them).
template <int kDiag, bool kMasked>
cudaError_t launch(bool vg, const Lattice& L, const Material& m,
                   float4* grad, const Tail& E, long long zeros,
                   cudaStream_t st) {
  if (vg) {
    stencil_vg_kernel<kDiag, kMasked>
        <<<(unsigned)(E.n + zeros), kThreads, 0, st>>>(L, m, grad, E);
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

const char* hdnn_error_string(int err) { return hdnn::error_string(err); }

}  // extern "C"
