// The one-launch tail of an energy kernel (K4, K6, K7) and the zero rows
// a row variant writes beside its own.
//
// sum_partials_kernel (p1_triangle.cuh) is a second launch of one block
// that sums the per-block partials of an energy launch in double in a
// fixed order.  energy_tail does the same sum inside the launch: every
// block (or, in K7, every tile) that has a partial stores it, with this
// launch's tag, in one 8-byte word, and the grid's last block waits for
// each word to carry the tag and adds the partials in the order and
// precision of sum_partials_kernel, so the energy keeps its bits.  A word
// is the partial and its ready flag at once, so no block fences anything:
// a block stores its word and retires.  No sum goes through an atomic.
//
// When the last block starts long before the others end (a launch with
// zero CTAs, whose last block is one; K4, whose blocks run long), its
// threads' loads of words that have not landed slowed the other blocks'
// loads.  Such a launch is counted (make_tail holds the rule): a block
// that stores a word also adds one to the slot's count (a relaxed add, no
// fence: it only tells the last block when to look), and one thread of
// the last block polls the count before its threads load the words.  In
// the other launches the atomic adds, all on one address, cost more than
// the polling.
//
// The words are never the caller's memory: g_words, zero when the library
// is loaded, is cut into slots, each its own run of words, and only these
// kernels ever write a slot's words, each with the tag of its launch.  A
// slot's tag (g_tags) only moves forward: the last block advances it
// after it has summed, so the next launch on the slot, or the next replay
// of a CUDA graph, waits for a tag no word holds yet.  A tag is never 0,
// so a word no launch has written never matches.  A slot keeps its words
// for good, so no word ever holds another slot's tag.  (The tag wraps
// after 2^32 - 1 launches of one slot.)
//
// A slot must never serve two launches that can run at once, so the C
// entry points take it from tail_slot: one for each (device, stream)
// outside a capture, and one for each (device, stream, capture) inside
// one.  Launches on one stream run in order; the launches a graph
// captured on one stream run in order too, and two replays of one graph
// never overlap (CUDA orders a graph's launches), so none of them can
// meet another on a slot.  A slot holds a power of two of words, at least
// the launch's partials; a stream or a capture that needs more than its
// slot holds takes a larger one and keeps both.  A capture's slots go
// back to be taken again when CUDA destroys its graph and the graph's
// last replay has ended (a user object of the graph, release_slots), so a
// process may record and drop any number of graphs; only the slots of the
// graphs alive at once, and of the streams, take words.  Each library
// keeps its own slots and words: 2M words (16 MB), 512 slots of the 4,096
// that K6 or K7 take on the 922K-class plate (2,208 partials).
//
// The same launches may write zeros to the output rows they do not own
// (zero_rows_outside), in extra blocks of the same grid, instead of a
// separate fill.

#pragma once

#include <cuda_runtime.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>
#include <vector>

#include "p1_triangle.cuh"

namespace hdnn {

constexpr int kTailSlots = 1 << 16;
// the words of every slot's partials: 16 MB
constexpr long long kTailWords = 1LL << 21;
// the fewest words a slot holds
constexpr long long kTailMinWords = 64;
// returned by tail_slot when every slot or every word is taken
// (error_string)
constexpr int kErrNoSlot = 100000;
constexpr int kErrNoWords = 100001;

__device__ unsigned int g_tags[kTailSlots];
__device__ unsigned int g_counts[kTailSlots];
__device__ unsigned long long g_words[kTailWords];

// where a launch's energy goes: its n partials (energy blocks or tiles,
// each one word from g_words[words]), their sum (*out, a device float),
// the launch's slot, and whether its partials are counted (see the header)
struct Tail {
  int n;
  float* out;
  int slot;
  long long words;
  bool counted;
};

// The tail of a launch of `grid` blocks, the first n of which have a
// partial each, summed into *out (its slot comes from tail_slot).  Its
// partials are counted when the grid's last block starts well before the
// blocks it waits for end: when zero CTAs follow the partials' blocks
// (the last block is one, done at once), or when each block runs long
// (`long_blocks`; K4's threads each walk a node's slots).
inline Tail make_tail(int n, long long grid, bool long_blocks, float* out) {
  return Tail{n, out, 0, 0, grid > n || long_blocks};
}

// A wait on the words sleeps 32 ns after its first try, twice as long
// after each next, up to kMaxNap ns (a wait on the count, 64 ns each
// time), and tries kMaxSpins times at most (~4 s) before it traps: a
// fault, never a hang.
constexpr unsigned int kMaxNap = 256;
constexpr long long kMaxSpins = 1LL << 24;

__device__ __forceinline__ unsigned long long load_word(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

// This launch's tag: the slot's count of finished launches, plus 1,
// skipping 0.
__device__ __forceinline__ unsigned int tail_tag(const Tail& E) {
  unsigned int done;
  asm volatile("ld.relaxed.gpu.u32 %0, [%1];"
               : "=r"(done)
               : "l"(&g_tags[E.slot])
               : "memory");
  return done + 1u == 0u ? 1u : done + 1u;
}

// Stores partial i (< E.n) of this launch, with its tag, in one word,
// and, in a counted launch, counts it in the slot's count (a relaxed add:
// the count only tells the last block when to look, the tags tell it what
// has landed).
__device__ __forceinline__ void tail_put(const Tail& E, unsigned int tag,
                                         int i, float partial) {
  const unsigned long long w =
      ((unsigned long long)tag << 32) | __float_as_uint(partial);
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(
                   g_words + E.words + i),
               "l"(w)
               : "memory");
  if (E.counted)
    asm volatile("red.relaxed.gpu.add.u32 [%0], %1;" ::"l"(
                     &g_counts[E.slot]),
                 "r"(1u)
                 : "memory");
}

// The sum of sum_partials_kernel over this launch's E.n partials, by the
// kThreads threads of one block (every thread calls it; the result is
// valid in thread 0): thread t holds the lanes t + r kThreads (r <
// kSumThreads / kThreads) of that kernel, whose warps are this block's
// warps, and adds each lane's partials in that kernel's order, so every
// add happens in the same order and precision.  A thread loads the words
// of a round all at once, then loads again, all at once, those that do
// not carry the tag yet, until every one does: one round trip to L2 a
// try, whichever words land last (loading each word on its own, in turn,
// cost a round trip a word).
template <int kThreads>
__device__ __forceinline__ double tail_sum(const Tail& E, unsigned int tag) {
  static_assert(kSumThreads % kThreads == 0 && kThreads % 32 == 0,
                "the block must tile sum_partials_kernel's lanes");
  constexpr int kLanes = kSumThreads / kThreads;
  constexpr int kWarps = kSumThreads / 32;
  constexpr int kRound = 2;  // partials a lane a round
  const unsigned long long* words = g_words + E.words;
  const int n = E.n;
  __shared__ double warp_sums[kWarps];
  double acc[kLanes];
#pragma unroll
  for (int r = 0; r < kLanes; ++r) acc[r] = 0.0;
  for (int base = 0; base < n; base += kSumThreads * kRound) {
    unsigned long long w[kLanes][kRound];
#pragma unroll
    for (int r = 0; r < kLanes; ++r)
#pragma unroll
      for (int u = 0; u < kRound; ++u) {
        const int i = base + u * kSumThreads + r * kThreads + threadIdx.x;
        w[r][u] = i < n ? load_word(words + i) : (unsigned long long)tag << 32;
      }
    unsigned int nap = 32;
    for (long long spin = 0;; ++spin) {
      bool ready = true;
#pragma unroll
      for (int r = 0; r < kLanes; ++r)
#pragma unroll
        for (int u = 0; u < kRound; ++u)
          ready = ready && (unsigned int)(w[r][u] >> 32) == tag;
      if (ready) break;
      if (spin == kMaxSpins) __trap();
      __nanosleep(nap);
      nap = nap < kMaxNap ? 2 * nap : nap;
#pragma unroll
      for (int r = 0; r < kLanes; ++r)
#pragma unroll
        for (int u = 0; u < kRound; ++u)
          if ((unsigned int)(w[r][u] >> 32) != tag)
            w[r][u] = load_word(words + base + u * kSumThreads +
                                r * kThreads + threadIdx.x);
    }
#pragma unroll
    for (int r = 0; r < kLanes; ++r)
#pragma unroll
      for (int u = 0; u < kRound; ++u)
        if (base + u * kSumThreads + r * kThreads + (int)threadIdx.x < n)
          acc[r] += __uint_as_float((unsigned int)w[r][u]);
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

// Every thread of every block of a launch of kThreads-thread blocks calls
// this after its last write of the output and of its partials (tail_put):
// the grid's last block sums the E.n partials into *E.out, puts the
// slot's count back to 0 and advances its tag; every other block is done.  The last block holds one CTA
// slot and the blocks it waits for run in the others, so the wait ends
// whatever the order of dispatch.
template <int kThreads>
__device__ __forceinline__ void tail_finish(const Tail& E) {
  if (blockIdx.x + 1 < gridDim.x) return;
  const unsigned int tag = tail_tag(E);
  // in a counted launch one thread waits for the count, so that the
  // block's loads of the words (tail_sum) start once they have most
  // likely all landed
  if (E.counted && threadIdx.x == 0) {
    const unsigned int* count = &g_counts[E.slot];
    for (long long spin = 0;; ++spin) {
      unsigned int done;
      asm volatile("ld.relaxed.gpu.u32 %0, [%1];"
                   : "=r"(done)
                   : "l"(count)
                   : "memory");
      if (done >= (unsigned int)E.n) break;
      if (spin == kMaxSpins) __trap();
      __nanosleep(64);
    }
  }
  __syncthreads();
  const double sum = tail_sum<kThreads>(E, tag);
  if (threadIdx.x == 0) {
    *E.out = (float)sum;
    g_counts[E.slot] = 0;
    g_tags[E.slot] = tag;
  }
}

// Block `blockIdx.x` of a launch ends: its energy `total` (valid in thread
// 0) goes to partial `partial` with the launch's `tag` (read in thread 0
// when the block starts, tail_tag, so that the load is done by the time
// it is needed; partial < 0: a block with no partial, whose tag is not
// read), then tail_finish.
template <int kThreads>
__device__ __forceinline__ void energy_tail(float total, int partial,
                                            unsigned int tag,
                                            const Tail& E) {
  if (threadIdx.x == 0 && partial >= 0) tail_put(E, tag, partial, total);
  tail_finish<kThreads>(E);
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

// The slots of tail_slot, one registry a library (never destroyed: a
// graph's release_slots may run while the process exits).
struct TailSlots {
  struct Slot {
    int id;
    long long words, size;
  };
  using Key = std::tuple<int, cudaStream_t, unsigned long long>;
  std::mutex mu;
  // the slots a (device, stream, capture) has taken, the one in use last
  std::map<Key, std::vector<Slot>> held;
  // slots given back, by device and size
  std::map<std::pair<int, long long>, std::vector<Slot>> spare;
  std::map<int, int> slots_taken;
  std::map<int, long long> words_taken;

  static TailSlots& get() {
    static TailSlots* slots = new TailSlots;
    return *slots;
  }

  // a slot of `size` words on `device`, given back or new (mu held)
  int take(int device, long long size, Slot* slot) {
    auto& back = spare[{device, size}];
    if (!back.empty()) {
      *slot = back.back();
      back.pop_back();
      return (int)cudaSuccess;
    }
    int& n = slots_taken[device];
    long long& used = words_taken[device];
    if (n >= kTailSlots) return kErrNoSlot;
    if (used + size > kTailWords) return kErrNoWords;
    *slot = Slot{n++, used, size};
    used += size;
    return (int)cudaSuccess;
  }

  // gives back every slot of `key`
  void give_back(const Key& key) {
    std::lock_guard<std::mutex> lock(mu);
    const auto it = held.find(key);
    if (it == held.end()) return;
    for (const Slot& s : it->second)
      spare[{std::get<0>(key), s.size}].push_back(s);
    held.erase(it);
  }
};

// A graph's user object: gives back the slots of its capture once CUDA
// has destroyed the graph and every replay of it has ended.  It runs on a
// thread of CUDA's and calls no CUDA function.
inline void CUDART_CB release_slots(void* key) {
  TailSlots::Key* k = (TailSlots::Key*)key;
  TailSlots::get().give_back(*k);
  delete k;
}

// The slot of a launch of E->n partials on `st` of `device` (see the
// header), in E->slot and E->words.  Returns cudaSuccess, a CUDA error of
// the capture query or of the graph's user object, kErrNoSlot or
// kErrNoWords.
inline int tail_slot(int device, cudaStream_t st, Tail* E) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  cudaGraph_t graph = nullptr;
  cudaError_t err = cudaStreamGetCaptureInfo(st, &status, &id, &graph);
  if (err != cudaSuccess) return (int)err;
  if (status != cudaStreamCaptureStatusActive) id = 0;
  long long size = kTailMinWords;
  while (size < E->n) size *= 2;
  TailSlots& slots = TailSlots::get();
  const TailSlots::Key key = std::make_tuple(device, st, id);
  bool first;
  TailSlots::Slot slot;
  {
    std::lock_guard<std::mutex> lock(slots.mu);
    auto it = slots.held.find(key);
    first = it == slots.held.end();
    if (!first && it->second.back().size >= E->n) {
      slot = it->second.back();
    } else {
      const int got = slots.take(device, size, &slot);
      if (got != (int)cudaSuccess) return got;
      slots.held[key].push_back(slot);
    }
  }
  if (first && id != 0) {
    // the capture's slots go back when its graph is destroyed
    TailSlots::Key* owned = new TailSlots::Key(key);
    cudaUserObject_t object;
    err = cudaUserObjectCreate(&object, owned, release_slots, 1,
                               cudaUserObjectNoDestructorSync);
    if (err != cudaSuccess) {
      delete owned;
      slots.give_back(key);
      return (int)err;
    }
    err = cudaGraphRetainUserObject(graph, object, 1,
                                    cudaGraphUserObjectMove);
    if (err != cudaSuccess) {
      cudaUserObjectRelease(object, 1);  // release_slots gives them back
      return (int)err;
    }
  }
  E->slot = slot.id;
  E->words = slot.words;
  return (int)cudaSuccess;
}

inline const char* error_string(int err) {
  if (err == kErrNoSlot)
    return "every slot of the one-launch energy sum is taken (one a "
           "stream and one a stream a CUDA-graph capture)";
  if (err == kErrNoWords)
    return "the one-launch energy sum's partial words are all taken (by "
           "the slots of the streams and of the CUDA graphs alive)";
  return cudaGetErrorString((cudaError_t)err);
}

}  // namespace hdnn
