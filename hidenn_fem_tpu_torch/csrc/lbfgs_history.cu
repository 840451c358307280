// The two passes of the compact L-BFGS over its [2m, P] history, for
// Hopper: the dots B = SY [y, s, g] ([2m, 3]) and the combination
// out = scale (gamma g + coef^T SY) ([P]).
//
// Replaces no pl.pallas_call: the JAX package leaves both products to XLA
// (hidenn_fem_tpu/solve/optimizers.py:155, `SY @ jnp.stack([y, s, g], 1)`,
// and :201, `gamma * g + coef @ SY`, both under
// default_matmul_precision("highest"), :135).  The port's plain versions
// are the same expressions in torch (ops/lbfgs_history.py), which cuBLAS
// runs as an N = 3, K = P sgemm (after a stacked copy of y, s, g) and a
// gemv.  At the 898K-element plate (m = 100, P = 1,803,696) the history is
// 1.44 GB of float32, read once by each pass.
//
// Bound: bytes.  Each pass reads the history once (2m P elements) and y,
// s, g or g once; the dots do 6 flops and the combination 2 flops per
// history element, far below the float32 rate.  So both kernels are
// streams over the history at 16 bytes a thread a load, with enough
// loads in flight to cover the memory latency.
//
// Dots.  P is cut into chunks of `chunk` elements, one block a chunk; the
// chunk is sized so that the grid holds about eight blocks per SM (and at
// most 24 KB of y, s, g).  A block stages its chunk of y, s and g in
// shared memory once, read through their own three pointers (no stacked
// copy); its warps then take the history's rows in turn, each lane
// striding along its row segment with 16-byte loads and three FMA chains
// against the staged vectors.  A row's three sums are reduced across the
// warp by shuffles and written to the block's partial [2m, 3].  A second,
// one-block-per-row launch adds the blocks' partials in a fixed order.
// No atomics: two launches give the same bits.
//
// Combination.  One thread owns 16 bytes of consecutive p (4 floats or 2
// doubles) and walks the 2m rows in ascending order, eight rows' loads
// issued before their FMAs; coef (2m values) sits in shared memory; gamma
// is read from its device pointer, so nothing waits on the host and the
// launch records in a CUDA graph.  out = scale * (gamma g + acc), with
// gamma g rounded before the add, as the plain expression does.  Where
// the packs of P are too few to fill the card (example 4's P = 81,204
// gives 20,301), the rows are split into 2, 4 or 8 ranges, each summed
// by its own thread of the block and the ranges' sums added in order.
//
// Rows not 16-byte aligned.  Row r starts at element r P, so when P is
// not a multiple of the vector width (4 floats, 2 doubles) or a pointer
// is not 16-byte aligned, the entry points pick the scalar variant (one
// element a load) of the same kernels.
//
// Types: float and double, each accumulated in its own type by plain
// SIMT FMAs (no tensor cores, no TF32: the compact L-BFGS algebra needs
// full-precision products).
//
// Built by hidenn_fem_tpu_torch/ops/cuda_build.py (nvcc for sm_90a) and
// bound through the plain C interface at the end of this file.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageBytes = 24 * 1024;  // y, s, g of one dots chunk
constexpr int kBlocksPerSm = 8;         // the dots grid's target
constexpr int kRowUnroll = 8;           // combination loads in flight
constexpr int kDefaultShared = 48 * 1024;

template <typename T>
struct Width {
  static constexpr int n = 16 / sizeof(T);  // elements in 16 bytes
};

// N elements from global memory: one 16-byte load, or one scalar.
__device__ __forceinline__ void load(const float* p, float (&o)[4]) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void load(const double* p, double (&o)[2]) {
  const double2 v = __ldg(reinterpret_cast<const double2*>(p));
  o[0] = v.x; o[1] = v.y;
}
template <typename T>
__device__ __forceinline__ void load(const T* p, T (&o)[1]) {
  o[0] = __ldg(p);
}

// N elements from shared memory.
__device__ __forceinline__ void lds(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}
__device__ __forceinline__ void lds(const double* p, double (&o)[2]) {
  const double2 v = *reinterpret_cast<const double2*>(p);
  o[0] = v.x; o[1] = v.y;
}
template <typename T>
__device__ __forceinline__ void lds(const T* p, T (&o)[1]) {
  o[0] = *p;
}

__device__ __forceinline__ void store(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store(double* p, const double (&v)[2]) {
  *reinterpret_cast<double2*>(p) = make_double2(v[0], v[1]);
}
template <typename T>
__device__ __forceinline__ void store(T* p, const T (&v)[1]) {
  *p = v[0];
}

// a * b and a + b, each rounded (never contracted into an FMA)
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;  // valid in lane 0
}

// Dots, pass 1: block b's partial [rows, 3] of SY [rows, p] against
// (y, s, g) over p in [b chunk, (b + 1) chunk).  chunk is a multiple of
// 32 Width<T>::n, so every chunk of a vector launch starts 16-byte
// aligned; N is that width, or 1 for the scalar variant.
template <typename T, int N>
__global__ void __launch_bounds__(kThreads)
dots_kernel(const T* __restrict__ sy, const T* __restrict__ y,
            const T* __restrict__ s, const T* __restrict__ g, long long p,
            int rows, int chunk, T* __restrict__ partials) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* vy = reinterpret_cast<T*>(smem);
  T* vs = vy + chunk;
  T* vg = vs + chunk;
  const long long p0 = (long long)blockIdx.x * chunk;
  const int n = (int)(p - p0 < chunk ? p - p0 : chunk);
  for (int i = threadIdx.x; i < n; i += kThreads) {
    vy[i] = __ldg(y + p0 + i);
    vs[i] = __ldg(s + p0 + i);
    vg[i] = __ldg(g + p0 + i);
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int packs = n / N;  // n % N == 0 for a vector launch (p % N == 0)
  for (int r = warp; r < rows; r += kWarps) {
    const T* row = sy + (long long)r * p + p0;
    T a0 = T(0), a1 = T(0), a2 = T(0);
#pragma unroll 4
    for (int j = lane; j < packs; j += 32) {
      T w[N], ty[N], ts[N], tg[N];
      load(row + j * N, w);
      lds(vy + j * N, ty);
      lds(vs + j * N, ts);
      lds(vg + j * N, tg);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        a0 = fma_rn(w[e], ty[e], a0);
        a1 = fma_rn(w[e], ts[e], a1);
        a2 = fma_rn(w[e], tg[e], a2);
      }
    }
    a0 = warp_sum(a0);
    a1 = warp_sum(a1);
    a2 = warp_sum(a2);
    if (lane == 0) {
      T* out = partials + ((long long)blockIdx.x * rows + r) * 3;
      out[0] = a0;
      out[1] = a1;
      out[2] = a2;
    }
  }
}

// Dots, pass 2: out[r, c] = the sum over blocks of partials[b, r, c], in
// a fixed order (one block a row).
template <typename T>
__global__ void __launch_bounds__(kThreads)
dots_finish_kernel(const T* __restrict__ partials, int n_blocks, int rows,
                   T* __restrict__ out) {
  __shared__ T sums[3][kWarps];
  const int r = blockIdx.x;
  T a[3] = {T(0), T(0), T(0)};
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    const T* q = partials + ((long long)b * rows + r) * 3;
    a[0] += q[0];
    a[1] += q[1];
    a[2] += q[2];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a[c] = warp_sum(a[c]);
    if (lane == 0) sums[c][warp] = a[c];
  }
  __syncthreads();
  if (threadIdx.x < 3) {
    T t = T(0);
    for (int w = 0; w < kWarps; ++w) t += sums[threadIdx.x][w];
    out[r * 3 + threadIdx.x] = t;
  }
}

// Combination: out[p] = scale (gamma g[p] + sum_r coef[r] SY[r, p]).  A
// block is `splits` groups of kThreads / splits threads; thread t of
// group k owns the pack of N elements at column (block, t) and sums the
// rows of the k-th of `splits` equal row ranges, in ascending order; the
// groups' sums are added in group order through shared memory.  Without
// Split, splits is 1 and none of that code is compiled in: compiled into
// the whole-row kernel it took 40 registers a thread against 32, 6 blocks
// an SM against 8, and 5% more time at the 898K shape (H100).
template <typename T, int N, bool Split>
__global__ void __launch_bounds__(kThreads)
combine_kernel(const T* __restrict__ sy, const T* __restrict__ g,
               const T* __restrict__ coef, const T* __restrict__ gamma,
               T scale, long long p, int rows, int n_splits,
               T* __restrict__ out) {
  const int splits = Split ? n_splits : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  T* c = reinterpret_cast<T*>(smem);
  // the groups' sums, after coef rounded up to 16 bytes
  T* red = c + (rows * sizeof(T) + 15) / 16 * 16 / sizeof(T);
  for (int i = threadIdx.x; i < rows; i += kThreads) c[i] = __ldg(coef + i);
  __syncthreads();
  const int cols = kThreads / splits;
  const int k = Split ? threadIdx.x / cols : 0;
  const int t = threadIdx.x - k * cols;
  const long long j = ((long long)blockIdx.x * cols + t) * N;
  const bool live = j < p;
  if (!Split && !live) return;
  T acc[N];
#pragma unroll
  for (int e = 0; e < N; ++e) acc[e] = T(0);
  if (live) {
    const T* col = sy + j;
    int r = Split ? (int)((long long)rows * k / splits) : 0;
    const int r_end = Split ? (int)((long long)rows * (k + 1) / splits)
                            : rows;
    for (; r + kRowUnroll <= r_end; r += kRowUnroll) {
      T w[kRowUnroll][N];
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u)
        load(col + (long long)(r + u) * p, w[u]);
#pragma unroll
      for (int u = 0; u < kRowUnroll; ++u) {
        const T cu = c[r + u];
#pragma unroll
        for (int e = 0; e < N; ++e) acc[e] = fma_rn(cu, w[u][e], acc[e]);
      }
    }
    for (; r < r_end; ++r) {
      T w[N];
      load(col + (long long)r * p, w);
      const T cr = c[r];
#pragma unroll
      for (int e = 0; e < N; ++e) acc[e] = fma_rn(cr, w[e], acc[e]);
    }
  }
  if (Split) {
    if (k > 0) {
#pragma unroll
      for (int e = 0; e < N; ++e) red[((k - 1) * cols + t) * N + e] = acc[e];
    }
    __syncthreads();
    if (k == 0) {
      for (int q = 1; q < splits; ++q) {
#pragma unroll
        for (int e = 0; e < N; ++e)
          acc[e] = add_rn(acc[e], red[((q - 1) * cols + t) * N + e]);
      }
    }
  }
  if (k > 0 || !live) return;
  const T gm = __ldg(gamma);
  T gv[N], o[N];
  load(g + j, gv);
#pragma unroll
  for (int e = 0; e < N; ++e)
    o[e] = mul_rn(scale, add_rn(mul_rn(gm, gv[e]), acc[e]));
  store(out + j, o);
}

bool aligned(const void* ptr) {
  return reinterpret_cast<std::uintptr_t>(ptr) % 16 == 0;
}

int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess || n < 1)
    return 132;
  return n;
}

// The dots chunk: about kBlocksPerSm blocks per SM, a multiple of 32
// vectors, at most kStageBytes of y, s, g.
template <typename T>
int dots_chunk(long long p, int device) {
  const long long unit = 32LL * Width<T>::n;
  const long long most = kStageBytes / (3 * (long long)sizeof(T));
  const long long target = (long long)kBlocksPerSm * sm_count(device);
  long long c = (p + target - 1) / target;
  c = (c + unit - 1) / unit * unit;
  return (int)(c < most ? c : most);
}

template <typename T>
int dots_blocks(long long p, int device) {
  const long long chunk = dots_chunk<T>(p, device);
  return (int)((p + chunk - 1) / chunk);
}

template <typename T>
cudaError_t launch_dots(int device, const T* sy, const T* y, const T* s,
                        const T* g, long long p, int rows, T* partials,
                        int n_blocks, T* out, cudaStream_t st) {
  const int chunk = dots_chunk<T>(p, device);
  if (n_blocks != dots_blocks<T>(p, device)) return cudaErrorInvalidValue;
  const size_t shared = 3 * (size_t)chunk * sizeof(T);
  constexpr int n = Width<T>::n;
  if (p % n == 0 && aligned(sy) && aligned(y) && aligned(s) && aligned(g))
    dots_kernel<T, n><<<n_blocks, kThreads, shared, st>>>(
        sy, y, s, g, p, rows, chunk, partials);
  else
    dots_kernel<T, 1><<<n_blocks, kThreads, shared, st>>>(
        sy, y, s, g, p, rows, chunk, partials);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dots_finish_kernel<T><<<rows, kThreads, 0, st>>>(partials, n_blocks, rows,
                                                   out);
  return cudaGetLastError();
}

// The combination's row split: 1 where the packs alone fill the card
// (kThreads a block, sm_count x 2048 threads), else the least power of
// two up to 8 (and at most the rows) that does.
int combine_splits(long long packs, int rows, int device) {
  const long long threads = 2048LL * sm_count(device);
  int splits = 1;
  while (splits < 8 && 2 * splits <= rows && packs * splits < threads)
    splits *= 2;
  return splits;
}

template <typename T, int N>
cudaError_t launch_combine_n(int device, const T* sy, const T* g,
                             const T* coef, const T* gamma, T scale,
                             long long p, int rows, T* out,
                             cudaStream_t st) {
  const long long packs = (p + N - 1) / N;
  const int splits = combine_splits(packs, rows, device);
  const int cols = kThreads / splits;
  const size_t shared = ((size_t)rows * sizeof(T) + 15) / 16 * 16
      + (size_t)(splits - 1) * cols * N * sizeof(T);
  const long long blocks = (packs + cols - 1) / cols;
  auto kernel = splits > 1 ? combine_kernel<T, N, true>
                           : combine_kernel<T, N, false>;
  if (shared > kDefaultShared) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return err;
  }
  kernel<<<(unsigned)blocks, kThreads, shared, st>>>(
      sy, g, coef, gamma, scale, p, rows, splits, out);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_combine(int device, const T* sy, const T* g,
                           const T* coef, const T* gamma, T scale,
                           long long p, int rows, T* out, cudaStream_t st) {
  constexpr int n = Width<T>::n;
  if (p % n == 0 && aligned(sy) && aligned(g) && aligned(out))
    return launch_combine_n<T, n>(device, sy, g, coef, gamma, scale, p,
                                  rows, out, st);
  return launch_combine_n<T, 1>(device, sy, g, coef, gamma, scale, p, rows,
                                out, st);
}

}  // namespace

extern "C" {

// Rows of the dots' partial buffer (one a block) for a history of p
// columns; is_double selects double (else float).
int hdnn_lbfgs_dots_blocks(int device, long long p, int is_double) {
  return is_double ? dots_blocks<double>(p, device)
                   : dots_blocks<float>(p, device);
}

// out [rows, 3] = SY [rows, p] @ [y, s, g]; partials holds
// n_blocks * rows * 3 elements (n_blocks from hdnn_lbfgs_dots_blocks).
int hdnn_lbfgs_history_dots(int device, int is_double, const void* sy,
                            const void* y, const void* s, const void* g,
                            long long p, int rows, void* partials,
                            int n_blocks, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    err = launch_dots<double>(device, (const double*)sy, (const double*)y,
                              (const double*)s, (const double*)g, p, rows,
                              (double*)partials, n_blocks, (double*)out, st);
  else
    err = launch_dots<float>(device, (const float*)sy, (const float*)y,
                             (const float*)s, (const float*)g, p, rows,
                             (float*)partials, n_blocks, (float*)out, st);
  return (int)err;
}

// out [p] = scale * (gamma * g + coef @ SY), gamma a device scalar.
int hdnn_lbfgs_history_combine(int device, int is_double, const void* sy,
                               const void* g, const void* coef,
                               const void* gamma, double scale, long long p,
                               int rows, void* out, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = (cudaStream_t)stream;
  if (is_double)
    err = launch_combine<double>(device, (const double*)sy,
                                 (const double*)g,
                                 (const double*)coef, (const double*)gamma,
                                 scale, p, rows, (double*)out, st);
  else
    err = launch_combine<float>(device, (const float*)sy, (const float*)g,
                                (const float*)coef, (const float*)gamma,
                                (float)scale, p, rows, (float*)out, st);
  return (int)err;
}

const char* hdnn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
