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
// Also here, the two tails of an energy launch.  sum_partials_kernel is a
// second launch of one block that sums the per-block partials in double
// in a fixed order (K1, K3, K8).  energy_tail does the same sum inside
// the launch (K4, K6, K7): every block writes its partial and adds one to
// a ticket counter, and the grid's last block, once the counter says
// every other block is done, sums the partials in the order and
// precision of sum_partials_kernel, so the energy keeps its bits.  The
// counter only tells that block when to start; no sum goes through an
// atomic.  What it costs: each block's release add waits for its own
// writes to land before the block retires, and the last block's sum
// follows the others inside the kernel; what it saves is the second
// launch, its graph node and the gap before it.  The same launches may
// write zeros to the output rows they do not own (zero_rows_outside), in
// extra blocks of the same grid, instead of a separate fill.
//
// The ticket counters live in g_tickets, zero when the library is loaded;
// the last block puts its counter back to 0, so the next launch on the
// slot, or the next replay of a CUDA graph, finds it zeroed.  A counter
// must never serve two launches that can run at once, so the C entry
// points take a slot from ticket_slot: one for each (device, stream)
// outside a capture, and one for each (device, stream, capture) inside
// one.  Launches on one stream run in order; the launches a graph
// captured on one stream run in order too, and two replays of one graph
// never overlap (CUDA orders a graph's launches), so none of them can
// meet another on a counter.  Each library keeps its own slots.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>

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

// ------------------------------------------------- the one-launch tail
constexpr int kTicketSlots = 1 << 16;
// returned by ticket_slot when every slot is taken (hdnn_error_string)
constexpr int kErrNoTicket = 100000;

__device__ unsigned int g_tickets[kTicketSlots];

// where a launch's energy goes: its energy CTAs' partials [n], their sum
// (*out, a device float) and the launch's ticket slot
struct Tail {
  float* partials;
  int n;
  float* out;
  int slot;
};

// The sum of sum_partials_kernel over the n partials, by the kThreads
// threads of one block (every thread calls it; the result is valid in
// thread 0): thread t holds the lanes t + r kThreads (r < kSumThreads /
// kThreads) of that kernel, whose warps are this block's warps, and adds
// each lane's partials in that kernel's order, so every add happens in the
// same order and precision.  All of a lane's loads of a round are issued
// before its adds (__ldcg: the other blocks' partials, past this SM's L1).
template <int kThreads>
__device__ __forceinline__ double sum_partials_block(
    const float* __restrict__ partials, int n) {
  static_assert(kSumThreads % kThreads == 0 && kThreads % 32 == 0,
                "the block must tile sum_partials_kernel's lanes");
  constexpr int kLanes = kSumThreads / kThreads;
  constexpr int kWarps = kSumThreads / 32;
  constexpr int kRound = 4;  // loads in flight a lane
  __shared__ double warp_sums[kWarps];
  double acc[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) acc[r] = 0.0;
  for (int base = 0; base < n; base += kSumThreads * kRound) {
    float v[kLanes][kRound];
#pragma unroll
    for (int r = 0; r < kLanes; ++r)
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int i = base + u * kSumThreads + r * kThreads + threadIdx.x;
        v[r][u] = i < n ? __ldcg(partials + i) : 0.f;
      }
#pragma unroll
    for (int r = 0; r < kLanes; ++r)
#pragma unroll
      for (int u = 0; u < kRound; ++u)
        if (base + u * kSumThreads + r * kThreads + (int)threadIdx.x < n)
          acc[r] += v[r][u];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int r = 0; r < kLanes; ++r)
      acc[r] += __shfl_down_sync(0xffffffffu, acc[r], off);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int r = 0; r < kLanes; ++r)
      warp_sums[(r * kThreads + threadIdx.x) >> 5] = acc[r];
  __syncthreads();
  double sum = 0.0;
  if (threadIdx.x == 0)
    for (int w = 0; w < kWarps; ++w) sum += warp_sums[w];
  return sum;
}

// Spins this long at most (in __nanosleep(64) rounds, ~1 s) for the
// other blocks' tickets before it traps: a fault, never a hang.
constexpr long long kMaxSpins = 1LL << 24;

// Block `blockIdx.x` of a launch of kThreads-thread blocks ends: its
// energy `total` (valid in thread 0) goes to E.partials[partial] (partial
// < 0: a block with no partial, which takes its ticket all the same).
// Every block but the grid's last adds one to its ticket counter (a
// release add, so its partial is visible first) and is done; the last
// block waits (acquire loads) until the other gridDim.x - 1 have, sums the
// E.n partials as sum_partials_kernel would (sum_partials_block) into
// *E.out and puts the counter back to 0.  The waiting block holds one
// CTA slot and the blocks it waits for run in the others, so the wait
// ends whatever the order of dispatch.  Every thread of every block calls
// it, after its last write of the output.
template <int kThreads>
__device__ __forceinline__ void energy_tail(float total, int partial,
                                            const Tail& E) {
  unsigned int* ticket = &g_tickets[E.slot];
  if (blockIdx.x + 1 < gridDim.x) {
    if (threadIdx.x == 0) {
      if (partial >= 0) E.partials[partial] = total;
      asm volatile("red.release.gpu.add.u32 [%0], %1;" ::"l"(ticket),
                   "r"(1u)
                   : "memory");
    }
    return;
  }
  if (threadIdx.x == 0) {
    if (partial >= 0) E.partials[partial] = total;
    __threadfence();
    unsigned int done = 0;
    for (long long spin = 0;; ++spin) {
      asm volatile("ld.acquire.gpu.u32 %0, [%1];"
                   : "=r"(done)
                   : "l"(ticket)
                   : "memory");
      if (done >= gridDim.x - 1) break;
      if (spin == kMaxSpins) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
  const double sum = sum_partials_block<kThreads>(E.partials, E.n);
  if (threadIdx.x == 0) {
    *E.out = (float)sum;
    *ticket = 0;
  }
}

// Zero block `block` (0, 1, ...) of a launch writes +0.0 to its share of
// the rows of out [n_rows] (float4) outside [keep_lo, keep_hi): counting
// those rows in order, the kThreads * kZeroRowsPerThread of them from
// block * kThreads * kZeroRowsPerThread, one 16-byte store a row,
// neighbouring threads on neighbouring rows.
constexpr int kZeroRowsPerThread = 8;

template <int kThreads>
__device__ __forceinline__ void zero_rows_outside(float4* __restrict__ out,
                                                  long long n_rows,
                                                  long long keep_lo,
                                                  long long keep_hi,
                                                  long long block) {
  const long long kept = keep_hi - keep_lo;
  const long long n_zero = n_rows - kept;
  const long long first = block * (kThreads * kZeroRowsPerThread);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < kZeroRowsPerThread; ++k) {
    const long long z = first + k * kThreads + threadIdx.x;
    if (z < n_zero) out[z < keep_lo ? z : z + kept] = zero;
  }
}

// blocks zero_rows_outside needs for n_zero rows
template <int kThreads>
inline long long zero_blocks(long long n_zero) {
  constexpr long long per = kThreads * kZeroRowsPerThread;
  return (n_zero + per - 1) / per;
}

// The ticket slot of a launch on `st` of `device` (see the header).
// Returns cudaSuccess, the error of the capture query, or kErrNoTicket.
inline int ticket_slot(int device, cudaStream_t st, int* slot) {
  static std::mutex mu;
  static std::map<std::tuple<int, cudaStream_t, unsigned long long>, int>
      slots;
  static std::map<int, int> taken;
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  const cudaError_t err = cudaStreamGetCaptureInfo(st, &status, &id);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) id = 0;
  std::lock_guard<std::mutex> lock(mu);
  const auto key = std::make_tuple(device, st, id);
  const auto it = slots.find(key);
  if (it != slots.end()) {
    *slot = it->second;
    return (int)cudaSuccess;
  }
  int& n = taken[device];
  if (n >= kTicketSlots) return kErrNoTicket;
  *slot = slots[key] = n++;
  return (int)cudaSuccess;
}

inline const char* error_string(int err) {
  if (err == kErrNoTicket)
    return "every ticket slot of the one-launch energy sum is taken "
           "(one a stream and one a stream a CUDA-graph capture)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // namespace hdnn
