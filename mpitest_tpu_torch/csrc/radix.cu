// Onesweep LSD radix sort passes for Hopper (sm_90a).
//
// Replaces the Pallas kernel of mpitest_tpu/ops/radix_pallas.py on the
// radix_pallas local-sort path:
//
//   K4 radix_pass  <- _pass_kernel behind _fused_pass (the pallas_call of
//                     fused_radix_sort, radix_pallas.py:186)
//
// A sort is a plan of passes (word widx, bit shift, digit width bits
// <= 8), least significant first.  Each pass is a STABLE counting sort of
// every word plane (up to four) by the digit (w[widx] >> shift) &
// (2^bits - 1), taken on uint32 words, from `in` to `out`.  The reference
// pads to a multiple of its 512-row chunk and bins the pads by index into
// an extra bin; these passes work on the n real rows only, which gives
// the same first n rows.
//
// The design is Onesweep (Adinets and Merrill, 2022), one launch a pass:
//
//   radix_histogram (once a sort, k4_histogram): reads every word plane
//     the plan touches once and counts the digits of EVERY planned pass.
//     LSD passes permute the keys but keep each digit's multiset, so the
//     counts hold for every pass.  A thread counts a run of equal digits
//     in a register and adds it to the block's shared histogram when the
//     digit changes, so sorted and all-equal planes cost few atomics.
//   radix_pass (once a pass, k4_onesweep): each CTA takes its tile index
//     from the pass's atomic counter, not from blockIdx, so every tile it
//     waits on has started.  Each warp owns 512 contiguous keys and ranks
//     them once, in order, against a warp-private shared histogram; the
//     lanes of one digit find each other with one ballot a digit bit
//     (__match_any_sync, one instruction, ranked slower in tuning on
//     the H100: PERF.md).  The warps' counts are combined in
//     warp order and the tile publishes each bin's count with the
//     AGGREGATE flag to status[tile][bin] at once.  It then reorders
//     itself stably in shared memory, so keys and ranks leave registers
//     before the wait, and only then looks back over its predecessors
//     (decoupled look-back, kLookAhead of them a round trip), summing
//     aggregates until it meets an INCLUSIVE prefix, and publishes its
//     own inclusive prefix.  A bin's global base is the exclusive scan of
//     the histogram (every tile scans the pass's 256 counts itself) plus
//     that prefix.  The tile is written slot by slot, so each digit's
//     keys leave as one contiguous run; the other planes follow through
//     the same slots (kept in shared memory).
//
// Status words are 64 bits: epoch << 34 | flag << 32 | count, so a count
// reaches n - 1 < 2^31 with room to spare.  The status array is epoch-
// tagged, not reset: radix_histogram clears the whole scratch once a sort
// (one memset), and pass k publishes with epoch k + 1, so a word left by
// pass k - 1 (or the memset) reads as "not yet published".  The scratch
// holds, in 32-bit words: the status array (tiles x 256 x 2), one tile
// counter per possible pass (kMaxPasses), and one 256-bin histogram per
// planned pass.
//
// Bound on the H100: HBM bytes.  A pass reads every plane once and writes
// it once; the sort adds one read of each touched plane (the histogram)
// and the status words (2 KiB per 8192-key tile and pass, written twice,
// read back mostly from L2).  Design floor: (passes x 2 x planes +
// touched planes) x 4n bytes / 3.35 TB/s, 2.88 ms at 2^28 one word (four
// passes).
//
// The digit sort (digit_count + digit_scatter) replaces no Pallas kernel:
// the reference orders the distributed radix's digits with lax.sort
// (mpitest_tpu/models/radix_sort.py), and counts its probe's digits by
// sorting them first, because scatter-add is slow on a TPU.  It is added
// for speed, in place of torch.sort(stable=True) of n int32 digits with
// an int64 index plane and a gather of every word plane by that index.
// It is a stable counting sort of 1-4 uint32 planes by one digit of up to
// 16 bits, the key either a bit field of one plane or a plane of digit
// values in [0, 2^bits], where 2^bits (a sentinel) sorts last and counts
// in no bin:
//
//   digit_count (k4_digit_count): one read of the key gives the digit's
//     2^bits-bin histogram h and its exclusive scan lo (the pair the
//     distributed radix exchanges), and the histograms of the scatter
//     passes (a pass takes at most kSweepBits bits, so a 16-bit digit,
//     or a 16-bit digit with its sentinel, takes two).  One block an SM
//     counts into 2^bits 16-bit counters in shared memory (two a word,
//     128 KB at 16 bits), reading each round's keys a round ahead; a
//     counter that reaches kDrain hands kDrain to the global histogram,
//     and a barrier every kCountRound keys keeps each below 2^16, so no
//     carry ever crosses into its neighbour.  The blocks add their
//     counters to h, two bins an atomic, and fold them into the pass
//     histograms; the launch is cooperative (every block resident), so
//     after a grid barrier every block sums slices of h, and after a
//     second one scans them into lo: no block reads all of h alone.
//   digit_scatter (k4_digit_scatter): one onesweep pass as K4's, moving
//     the planes themselves (no index plane and no gather), on digits of
//     up to 8 bits (256 bins) or, for a digit with its sentinel's bit, 9
//     (512 bins).
//
// Bound on the H100: HBM bytes.  A bit-field digit of one plane: the
// count reads the plane, and each of two passes reads and writes it
// (20 bytes a key, 0.200 ms at 2^25); a digit plane beside one word plane:
// 36 bytes a key (0.360 ms); the count alone 4 bytes a key (0.040 ms).
//
// Every entry point launches on the caller's stream, and returns
// cudaGetLastError() (0 on success); none allocates.

#include <atomic>
#include <cstdint>
#include <type_traits>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 4;
constexpr int kMaxBits = 8;
constexpr int kBins = 1 << kMaxBits;           // histogram and status stride
constexpr int kMaxPasses = 128;                // 4 words x 32 one-bit digits
constexpr int kMaxHistBins = kMaxPlanes * 4 * kBins;  // sum of 2^bits, <= 8-bit digits
constexpr int kThreads = 512;                  // onesweep block
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                     // keys per lane per tile
constexpr int kWarpSpan = 32 * kItems;         // contiguous keys per warp
constexpr int kTile = kWarps * kWarpSpan;      // 8192 keys per tile
constexpr int kMinBlocks = 2;                  // onesweep blocks an SM
constexpr int kLookAhead = 4;                  // predecessors read at once
constexpr int kHistThreads = 512;
constexpr int kHistItems = 16;                 // keys per thread per chunk
constexpr int kHistChunk = kHistThreads * kHistItems;
constexpr int kHistBlocksPerSm = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kFlagAggregate = 1ull << 32;
constexpr unsigned long long kFlagInclusive = 2ull << 32;
constexpr int kEpochShift = 34;
static_assert(kBins <= kThreads, "one thread per bin");
// the digit sort
constexpr int kSweepBits = 9;                  // widest digit of a scatter pass
constexpr int kSweepBins = 1 << kSweepBits;    // its status stride and bins
constexpr int kDigitMaxBits = 16;              // widest digit the count takes
constexpr int kCountThreads = 1024;
constexpr int kCountItems = 16;                // keys per thread per round
constexpr int kCountRound = kCountThreads * kCountItems;
// The count's scan of h: slices of kCountSlice bins (one uint4 a thread),
// at most kCountSlices of them.
constexpr int kCountSlice = 4 * kCountThreads;
constexpr int kCountSlices = (1 << kDigitMaxBits) / kCountSlice;
// The count buffer: the two pass histograms, a tile counter a pass, the
// count's grid-barrier counter and a pad, each slice's total, then h and
// lo (2^bits each; h at a 16-byte multiple).
constexpr int kCountHead = 2 * kSweepBins + 4 + kCountSlices;
constexpr int kCountBarrier = 2 * kSweepBins + 2;
constexpr int kCountTotals = 2 * kSweepBins + 4;
static_assert(kCountHead % 4 == 0, "h and lo are read and written as uint4");
constexpr uint32_t kDrain = 1u << 15;          // a 16-bit counter's hand-off
static_assert(kDrain + kCountRound < (1u << 16), "a counter stays below 2^16");
static_assert(kSweepBins <= kThreads, "one thread per bin");
static_assert(kCountThreads == 32 * 32, "the count's scan takes 32 warps");

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
};

// The plan as the histogram kernel reads it: for pass k, the plane, the
// shift, the digit width, and the offset of its bins in the compact
// shared histogram.
struct Plan {
  int n_passes;
  uint8_t widx[kMaxPasses];
  uint8_t shift[kMaxPasses];
  uint8_t bits[kMaxPasses];
  uint16_t off[kMaxPasses];
};

long long tiles_for(long long n) { return (n + kTile - 1) / kTile; }

// 32-bit words of the scratch: status, tile counters, histograms.
long long status_words(long long n) { return tiles_for(n) * kBins * 2; }
long long scratch_words_for(long long n, int n_passes) {
  return status_words(n) + kMaxPasses + static_cast<long long>(n_passes) * kBins;
}

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  return *reinterpret_cast<const volatile unsigned long long*>(p);
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  *reinterpret_cast<volatile unsigned long long*>(p) = v;
}

// Lanes of the warp whose digit equals this lane's: one ballot a bit of
// the digit's DigitBits + 1 (bits above a narrow digit are 0 in every
// key; bit DigitBits is set only in the invalid digit 2^DigitBits, the
// digit of the lanes past n, so they group with each other and never
// with a key).
template <int DigitBits>
__device__ __forceinline__ unsigned peers_of(uint32_t d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b <= DigitBits; ++b) {
    const bool set = (d >> b) & 1u;
    const unsigned m = __ballot_sync(kFull, set);
    peers &= set ? m : ~m;
  }
  return peers;
}

// Inclusive scan of x across the 32 lanes of a warp.
__device__ __forceinline__ uint32_t warp_inclusive(uint32_t x, unsigned lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, x, o);
    if (lane >= static_cast<unsigned>(o)) x += y;
  }
  return x;
}

__global__ void __launch_bounds__(kHistThreads)
k4_histogram(Planes p, uint32_t n, Plan plan, uint32_t* __restrict__ hist) {
  __shared__ uint32_t h[kMaxHistBins];
  const int total = plan.off[plan.n_passes - 1] + (1 << plan.bits[plan.n_passes - 1]);
  for (int b = threadIdx.x; b < total; b += blockDim.x) h[b] = 0;
  __syncthreads();
  unsigned touched = 0;  // planes the plan reads, as bits
  for (int k = 0; k < plan.n_passes; ++k) touched |= 1u << plan.widx[k];
  for (size_t base = static_cast<size_t>(blockIdx.x) * kHistChunk; base < n;
       base += static_cast<size_t>(gridDim.x) * kHistChunk) {
#pragma unroll 1
    for (int q = 0; q < kMaxPlanes; ++q) {
      if (!((touched >> q) & 1u)) continue;
      uint32_t v[kHistItems];
#pragma unroll
      for (int i = 0; i < kHistItems; ++i) {
        const size_t e = base + static_cast<size_t>(i) * kHistThreads + threadIdx.x;
        v[i] = e < n ? p.in[q][e] : 0u;
      }
      for (int k = 0; k < plan.n_passes; ++k) {
        if (plan.widx[k] != q) continue;
        const int shift = plan.shift[k];
        const uint32_t mask = (1u << plan.bits[k]) - 1u;
        uint32_t* hk = h + plan.off[k];
        // a run of equal digits is counted in a register, added once
        uint32_t run_d = 0, run_c = 0;
#pragma unroll
        for (int i = 0; i < kHistItems; ++i) {
          const size_t e = base + static_cast<size_t>(i) * kHistThreads + threadIdx.x;
          if (e >= n) break;
          const uint32_t d = (v[i] >> shift) & mask;
          if (run_c != 0 && d != run_d) {
            atomicAdd(&hk[run_d], run_c);
            run_c = 0;
          }
          run_d = d;
          ++run_c;
        }
        if (run_c != 0) atomicAdd(&hk[run_d], run_c);
      }
    }
  }
  __syncthreads();
  for (int k = 0; k < plan.n_passes; ++k) {
    const int bins = 1 << plan.bits[k];
    for (int b = threadIdx.x; b < bins; b += blockDim.x) {
      const uint32_t c = h[plan.off[k] + b];
      if (c != 0) atomicAdd(&hist[static_cast<size_t>(k) * kBins + b], c);
    }
  }
}

// One onesweep pass on digits of at most DigitBits bits: K4's take 8
// (256 bins), the digit sort's 9 (512).  Its dynamic shared memory holds
// the tile's values in sorted order (one plane at a time), each key's
// sorted slot (in key order), and each sorted slot's digit.
template <int DigitBits>
struct Sweep {
  using Digit = typename std::conditional<(DigitBits <= 8), uint8_t, uint16_t>::type;
  static constexpr int bins = 1 << DigitBits;  // status stride, shared rows
  static constexpr size_t dyn_smem =
      kTile * sizeof(uint32_t) + kTile * sizeof(uint16_t) + kTile * sizeof(Digit);
  static_assert(bins <= kThreads, "one thread per bin");
};
constexpr size_t kOnesweepDynSmem = Sweep<kMaxBits>::dyn_smem;
static_assert(kTile <= 65536, "tile-local slots are 16-bit");

template <int DigitBits>
__device__ __forceinline__ void onesweep_pass(
    Planes p, int n_planes, int widx, uint32_t n, int shift, int bits,
    const uint32_t* __restrict__ hist, unsigned long long* status,
    uint32_t* counter, unsigned long long epoch) {
  constexpr int B = Sweep<DigitBits>::bins;
  constexpr uint32_t kInvalid = B;             // groups the lanes past n
  using Digit = typename Sweep<DigitBits>::Digit;
  const int bins = 1 << bits;
  const uint32_t mask = static_cast<uint32_t>(bins - 1);
  extern __shared__ uint32_t dyn[];
  uint32_t* buf = dyn;                                           // kTile values
  uint16_t* slot_of = reinterpret_cast<uint16_t*>(dyn + kTile);  // kTile slots
  Digit* dig = reinterpret_cast<Digit*>(slot_of + kTile);        // kTile digits
  __shared__ uint32_t warp_off[kWarps][B];     // warp counts, then starts
  __shared__ uint32_t warp_sum[2][kWarps];     // the scans' warp totals
  __shared__ uint32_t local_start[B];          // tile-local first slot of bin
  __shared__ uint32_t bin_base[B];             // the pass's first slot of bin
  __shared__ uint32_t out_base[B];             // global slot of local slot 0
  __shared__ uint32_t tile_index;
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) tile_index = atomicAdd(counter, 1u);
  for (int b = lane; b < B; b += 32) warp_off[warp][b] = 0;
  __syncthreads();
  const uint32_t tile = tile_index;
  const size_t tile_base = static_cast<size_t>(tile) * kTile;
  const uint32_t tile_n = static_cast<uint32_t>(
      n - tile_base < static_cast<size_t>(kTile) ? n - tile_base : kTile);
  const uint32_t wlocal = warp * kWarpSpan;     // the warp's first key, tile-local

  // rank: each key's place among the equal digits of its warp, in order
  const uint32_t* key_in = p.in[widx] + tile_base;
  uint32_t key[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t e = wlocal + i * 32 + lane;
    key[i] = e < tile_n ? key_in[e] : 0u;
  }
  uint32_t rank[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const bool valid = wlocal + i * 32 + lane < tile_n;
    const uint32_t d = valid ? (key[i] >> shift) & mask : kInvalid;
    const unsigned peers = peers_of<DigitBits>(d);
    const uint32_t below = __popc(peers & lanemask_lt());
    const uint32_t seen = valid ? warp_off[warp][d] : 0u;
    __syncwarp();
    if (valid && below == 0) warp_off[warp][d] = seen + __popc(peers);
    __syncwarp();
    rank[i] = seen + below;
  }
  __syncthreads();

  // warps combined in order, one bin a thread; the tile's count of each
  // bin is published at once, so later tiles can look past this one
  unsigned long long* mine = status + static_cast<size_t>(tile) * B + threadIdx.x;
  const unsigned long long tag = epoch << kEpochShift;
  const bool has_bin = threadIdx.x < static_cast<unsigned>(bins);
  uint32_t count = 0;
  if (has_bin) {
    const int b = threadIdx.x;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_off[w][b];
      warp_off[w][b] = count;
      count += c;
    }
    store_status(mine, tag | (tile == 0 ? kFlagInclusive : kFlagAggregate) | count);
  }

  // bins' tile-local starts (the scan of the tile's counts) and their
  // bases in the pass (the scan of the pass's histogram), one bin a thread
  const uint32_t total = has_bin ? hist[threadIdx.x] : 0u;
  const uint32_t in_count = warp_inclusive(count, lane);
  const uint32_t in_total = warp_inclusive(total, lane);
  if (lane == 31) {
    warp_sum[0][warp] = in_count;
    warp_sum[1][warp] = in_total;
  }
  __syncthreads();
  if (has_bin) {
    uint32_t sc = in_count - count, st = in_total - total;
    for (unsigned w = 0; w < warp; ++w) {
      sc += warp_sum[0][w];
      st += warp_sum[1][w];
    }
    local_start[threadIdx.x] = sc;
    bin_base[threadIdx.x] = st;
  }
  __syncthreads();

  // the tile sorted stably in shared memory; keys and ranks die here, so
  // the look-back below runs with few live registers
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const uint32_t e = wlocal + i * 32 + lane;
    if (e < tile_n) {
      const uint32_t d = (key[i] >> shift) & mask;
      const uint32_t slot = local_start[d] + warp_off[warp][d] + rank[i];
      buf[slot] = key[i];
      dig[slot] = static_cast<Digit>(d);
      slot_of[e] = static_cast<uint16_t>(slot);
    }
  }

  // decoupled look-back: up to kLookAhead predecessors a round trip,
  // summed in order until an inclusive prefix; an unpublished one is read
  // again.  Tile 0 is always inclusive, so the walk ends.
  if (threadIdx.x < static_cast<unsigned>(bins)) {
    const int b = threadIdx.x;
    uint32_t prefix = 0;
    if (tile != 0) {
      const unsigned long long* prev = mine - B;
      uint32_t left = tile;  // tiles before prev's, prev's included
      bool done = false;
      while (!done) {
        unsigned long long st[kLookAhead];
#pragma unroll
        for (int j = 0; j < kLookAhead; ++j) {
          st[j] = static_cast<uint32_t>(j) < left ? load_status(prev - j * B) : 0ull;
        }
        uint32_t taken = 0;
        bool stop = false;
#pragma unroll
        for (int j = 0; j < kLookAhead; ++j) {
          if (stop || static_cast<uint32_t>(j) >= left) {
            stop = true;
          } else if ((st[j] >> kEpochShift) != epoch) {
            stop = true;  // not published yet
          } else {
            prefix += static_cast<uint32_t>(st[j]);
            ++taken;
            if (st[j] & kFlagInclusive) stop = done = true;
          }
        }
        prev -= static_cast<size_t>(taken) * B;
        left -= taken;
      }
      store_status(mine, tag | kFlagInclusive | (prefix + count));
    }
    // modular: out_base[b] + slot is exact for every slot of bin b
    out_base[b] = bin_base[b] + prefix - local_start[b];
  }
  __syncthreads();

  // write out in sorted order: consecutive slots of one digit go to
  // consecutive global addresses; the other planes follow the same slots
  for (uint32_t j = threadIdx.x; j < tile_n; j += kThreads) {
    p.out[widx][out_base[dig[j]] + j] = buf[j];
  }
#pragma unroll 1
  for (int q = 0; q < n_planes; ++q) {
    if (q == widx) continue;
    __syncthreads();  // buf is free again
    const uint32_t* in = p.in[q] + tile_base;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const uint32_t e = wlocal + i * 32 + lane;
      if (e < tile_n) buf[slot_of[e]] = in[e];
    }
    __syncthreads();
    for (uint32_t j = threadIdx.x; j < tile_n; j += kThreads) {
      p.out[q][out_base[dig[j]] + j] = buf[j];
    }
  }
}

// K4: one pass of a fused radix sort (radix_pass).
__global__ void __launch_bounds__(kThreads, kMinBlocks)
k4_onesweep(Planes p, int n_planes, int widx, uint32_t n, int shift, int bits,
            const uint32_t* __restrict__ hist, unsigned long long* status,
            uint32_t* counter, unsigned long long epoch) {
  onesweep_pass<kMaxBits>(p, n_planes, widx, n, shift, bits, hist, status,
                          counter, epoch);
}

// One scatter pass of the digit sort (digit_scatter): the 8-bit form for
// digits of up to 8 bits (half the bins to clear, publish and scan), the
// 9-bit one for a digit with its sentinel's bit.
template <int DigitBits>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
k4_digit_scatter(Planes p, int n_planes, int widx, uint32_t n, int shift,
                 int bits, const uint32_t* __restrict__ hist,
                 unsigned long long* status, uint32_t* counter,
                 unsigned long long epoch) {
  onesweep_pass<DigitBits>(p, n_planes, widx, n, shift, bits, hist, status,
                           counter, epoch);
}

// A barrier of every block of a cooperative launch (all resident): one
// counter, taken to `target` by its gridDim.x blocks once a barrier.
__device__ __forceinline__ void grid_barrier(uint32_t* counter, uint32_t target) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(counter, 1u);
    while (*reinterpret_cast<volatile uint32_t*>(counter) < target) __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

// The digit sort's count: h (counts + kCountHead) and lo (after it) of
// the digit (key >> shift) & (2^key_bits - 1) of n keys, a digit of 2^bits
// or more counting in no bin, and the histograms of the scatter passes
// (counts[0, 512): the low low_bits bits; counts[512, 1024): the rest, when
// key_bits > low_bits), each with the uncounted keys in the sentinel's
// bin.  The counts buffer starts zeroed.
__global__ void __launch_bounds__(kCountThreads, 1)
k4_digit_count(const uint32_t* __restrict__ key, uint32_t n, int shift,
               int key_bits, int bits, int low_bits, uint32_t* counts) {
  extern __shared__ uint32_t packed[];  // bin b: half b & 1 of word b / 2
  __shared__ uint32_t scan[32];
  __shared__ uint32_t pass_hist[2][kSweepBins];
  const uint32_t nb = 1u << bits;
  const uint32_t kmask = (1u << key_bits) - 1u;
  const bool two = low_bits < key_bits;
  const uint32_t lmask = (1u << low_bits) - 1u;
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = threadIdx.x >> 5;
  uint32_t* h = counts + kCountHead;
  // h as pairs of bins: one 64-bit add moves both counts of a word (each
  // sum stays below n < 2^31, so nothing carries into the upper one)
  unsigned long long* h2 = reinterpret_cast<unsigned long long*>(h);
  for (uint32_t i = threadIdx.x; i < nb / 2; i += kCountThreads) packed[i] = 0;
  for (int b = threadIdx.x; b < 2 * kSweepBins; b += kCountThreads) {
    pass_hist[b / kSweepBins][b % kSweepBins] = 0;
  }
  __syncthreads();
  const size_t step = static_cast<size_t>(gridDim.x) * kCountRound;
  size_t base = static_cast<size_t>(blockIdx.x) * kCountRound;
  uint32_t next[kCountItems];  // the next round's keys, loaded a round ahead
#pragma unroll
  for (int i = 0; i < kCountItems; ++i) {
    const size_t e = base + static_cast<size_t>(i) * kCountThreads + threadIdx.x;
    next[i] = e < n ? key[e] : 0u;
  }
  for (; base < n; base += step) {
    uint32_t v[kCountItems];
#pragma unroll
    for (int i = 0; i < kCountItems; ++i) {
      v[i] = next[i];
      const size_t e = base + step + static_cast<size_t>(i) * kCountThreads + threadIdx.x;
      next[i] = e < n ? key[e] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kCountItems; ++i) {
      const size_t e = base + static_cast<size_t>(i) * kCountThreads + threadIdx.x;
      const uint32_t d = (v[i] >> shift) & kmask;
      if (e < n && d < nb) {
        const int half = 16 * static_cast<int>(d & 1u);
        const uint32_t old = atomicAdd(&packed[d >> 1], 1u << half);
        if (((old >> half) & 0xffffu) == kDrain - 1) {
          // this add took the counter to kDrain: hand it on; no other add
          // of this round can take it there again
          atomicSub(&packed[d >> 1], kDrain << half);
          atomicAdd(&h2[d >> 1], static_cast<unsigned long long>(kDrain) << (2 * half));
          atomicAdd(&pass_hist[0][d & lmask], kDrain);
          if (two) atomicAdd(&pass_hist[1][d >> low_bits], kDrain);
        }
      }
    }
    __syncthreads();  // each counter below kDrain again
  }

  // the counters added to h, two bins an add, and folded into the pass
  // histograms: a thread's words lie 1024 apart, 2048 bins, a multiple of
  // 2^low_bits, so its two bins keep their lower digit from word to word,
  // and a warp's 64 bins share their upper digit when low_bits >= 6
  const bool warp_upper = two && low_bits >= 6 && nb >= 2 * kCountThreads;
  uint32_t lower0 = 0, lower1 = 0;
  for (uint32_t i = threadIdx.x; i < nb / 2; i += kCountThreads) {
    const uint32_t w = packed[i];
    const uint32_t c0 = w & 0xffffu, c1 = w >> 16;
    if (w != 0) atomicAdd(&h2[i], (static_cast<unsigned long long>(c1) << 32) | c0);
    lower0 += c0;
    lower1 += c1;
    if (warp_upper) {
      const uint32_t upper = __reduce_add_sync(kFull, c0 + c1);
      if (lane == 0 && upper != 0) atomicAdd(&pass_hist[1][(2 * i) >> low_bits], upper);
    } else if (two) {
      if (c0 != 0) atomicAdd(&pass_hist[1][(2 * i) >> low_bits], c0);
      if (c1 != 0) atomicAdd(&pass_hist[1][(2 * i + 1) >> low_bits], c1);
    }
  }
  if (lower0 != 0) atomicAdd(&pass_hist[0][(2 * threadIdx.x) & lmask], lower0);
  if (lower1 != 0) atomicAdd(&pass_hist[0][(2 * threadIdx.x + 1) & lmask], lower1);
  __syncthreads();
  for (int b = threadIdx.x; b < 2 * kSweepBins; b += kCountThreads) {
    const uint32_t c = pass_hist[b / kSweepBins][b % kSweepBins];
    if (c != 0) atomicAdd(&counts[b], c);
  }

  // h is whole once every block is past the first barrier (the launch is
  // cooperative: every block is resident).  Each block then takes slices
  // of kCountSlice bins, kCountSlices blocks apart: their totals, a second
  // barrier, and lo from the totals before each slice and a block scan.
  uint32_t* bar = counts + kCountBarrier;
  uint32_t* totals = counts + kCountTotals;
  uint32_t* lo = h + nb;
  const uint32_t slices = (nb + kCountSlice - 1) / kCountSlice;
  const auto load4 = [&](uint32_t b, uint32_t (&c)[4]) {
    if (nb >= 4 && b < nb) {  // nb and b are multiples of 4: all four bins
      const uint4 q = __ldcg(reinterpret_cast<const uint4*>(h + b));
      c[0] = q.x; c[1] = q.y; c[2] = q.z; c[3] = q.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) c[j] = b + j < nb ? __ldcg(&h[b + j]) : 0u;
    }
  };
  // the block's exclusive scan of one value a thread; the block's total
  const auto block_scan = [&](uint32_t x, uint32_t& total) {
    const uint32_t inc = warp_inclusive(x, lane);
    if (lane == 31) scan[warp] = inc;
    __syncthreads();
    if (warp == 0) scan[lane] = warp_inclusive(scan[lane], lane);
    __syncthreads();
    const uint32_t before = (warp == 0 ? 0u : scan[warp - 1]) + inc - x;
    total = scan[31];
    __syncthreads();  // scan is written again
    return before;
  };
  grid_barrier(bar, gridDim.x);
  for (uint32_t sl = blockIdx.x; sl < slices; sl += gridDim.x) {
    uint32_t c[4], total;
    load4(sl * kCountSlice + 4 * threadIdx.x, c);
    block_scan(c[0] + c[1] + c[2] + c[3], total);
    if (threadIdx.x == 0) totals[sl] = total;
  }
  grid_barrier(bar, 2 * gridDim.x);
  for (uint32_t sl = blockIdx.x; sl < slices; sl += gridDim.x) {
    const uint32_t b = sl * kCountSlice + 4 * threadIdx.x;
    uint32_t c[4], total;
    load4(b, c);
    uint32_t run = block_scan(c[0] + c[1] + c[2] + c[3], total);
    for (uint32_t k = 0; k < sl; ++k) run += __ldcg(&totals[k]);
    uint32_t at[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      at[j] = run;
      run += c[j];
    }
    if (nb >= 4) {
      if (b < nb) *reinterpret_cast<uint4*>(lo + b) = make_uint4(at[0], at[1], at[2], at[3]);
    } else {
      for (uint32_t j = 0; b + j < nb; ++j) lo[b + j] = at[j];
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {  // the sentinel's keys, in its bins
    uint32_t total = 0;
    for (uint32_t k = 0; k < slices; ++k) total += __ldcg(&totals[k]);
    if (total != n) {
      atomicAdd(&counts[nb & lmask], n - total);
      if (two && (nb >> low_bits) < kSweepBins) {
        atomicAdd(&counts[kSweepBins + (nb >> low_bits)], n - total);
      }
    }
  }
}

// Per-card facts every call needs, looked up once a card: the SM count
// (sizes the histogram grids) and whether each kernel's dynamic shared
// memory limit is raised.  A race only repeats an idempotent lookup.
constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices];
std::atomic<bool> g_onesweep_smem[kMaxDevices];
std::atomic<bool> g_scatter8_smem[kMaxDevices];
std::atomic<bool> g_scatter9_smem[kMaxDevices];
std::atomic<bool> g_count_smem[kMaxDevices];

long long sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached) sms = g_sms[dev].load(std::memory_order_relaxed);
  if (sms == 0) {
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms < 1) sms = 1;
    if (cached) g_sms[dev].store(sms, std::memory_order_relaxed);
  }
  return sms;
}

// Raise `kernel`'s dynamic shared memory limit to `bytes` on the current
// card, once a card (`done` remembers it).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, std::atomic<bool>* done) {
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && done[dev].load(std::memory_order_relaxed)) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess && cached) done[dev].store(true, std::memory_order_relaxed);
  return err;
}

bool bad_shape(int n_planes, long long n) {
  return n_planes < 1 || n_planes > kMaxPlanes || n < 1 || n >= (1LL << 31);
}

bool bad_digit(int widx, int n_planes, int shift, int bits,
               int max_bits = kMaxBits) {
  return widx < 0 || widx >= n_planes || bits < 1 || bits > max_bits ||
         shift < 0 || shift + bits > 32;
}

// 32-bit words of the digit sort's status: one 64-bit word per tile and
// bin of a scatter pass.
long long sweep_status_words(long long n) { return tiles_for(n) * kSweepBins * 2; }

template <int DigitBits>
cudaError_t launch_scatter(const Planes& p, int n_planes, int widx, long long n,
                           int shift, int bits, int pass, uint32_t* counts,
                           void* status, cudaStream_t s, std::atomic<bool>* smem_done) {
  const cudaError_t attr = allow_smem(k4_digit_scatter<DigitBits>,
                                      Sweep<DigitBits>::dyn_smem, smem_done);
  if (attr != cudaSuccess) return attr;
  k4_digit_scatter<DigitBits><<<static_cast<unsigned>(tiles_for(n)), kThreads,
                                Sweep<DigitBits>::dyn_smem, s>>>(
      p, n_planes, widx, static_cast<uint32_t>(n), shift, bits,
      counts + static_cast<size_t>(pass) * kSweepBins,
      static_cast<unsigned long long*>(status), counts + 2 * kSweepBins + pass,
      static_cast<unsigned long long>(pass) + 1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The histogram of a sort: clears the scratch (scratch_words 32-bit
// words, at least status + tile counters + n_passes histograms for n), then
// counts the digits of every pass of `plan` (host memory, n_passes triples
// widx, shift, bits) over the n_planes uint32 planes in0..3.
int radix_histogram(const void* in0, const void* in1, const void* in2,
                    const void* in3, int n_planes, long long n,
                    const void* plan, int n_passes, void* scratch,
                    long long scratch_words, void* stream) {
  if (bad_shape(n_planes, n) || n_passes < 1 || n_passes > kMaxPasses ||
      scratch_words < scratch_words_for(n, n_passes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int* triples = static_cast<const int*>(plan);
  Plan pl{};
  pl.n_passes = n_passes;
  int off = 0;
  for (int k = 0; k < n_passes; ++k) {
    const int widx = triples[3 * k], shift = triples[3 * k + 1],
              bits = triples[3 * k + 2];
    if (bad_digit(widx, n_planes, shift, bits)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    pl.widx[k] = static_cast<uint8_t>(widx);
    pl.shift[k] = static_cast<uint8_t>(shift);
    pl.bits[k] = static_cast<uint8_t>(bits);
    pl.off[k] = static_cast<uint16_t>(off);
    off += 1 << bits;
    if (off > kMaxHistBins) return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes p{};
  const void* ins[kMaxPlanes] = {in0, in1, in2, in3};
  for (int q = 0; q < n_planes; ++q) p.in[q] = static_cast<const uint32_t*>(ins[q]);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* words = static_cast<uint32_t*>(scratch);
  cudaError_t err = cudaMemsetAsync(
      words, 0, static_cast<size_t>(scratch_words_for(n, n_passes)) * 4, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long chunks = (n + kHistChunk - 1) / kHistChunk;
  const long long cap = sm_count() * kHistBlocksPerSm;
  const unsigned blocks = static_cast<unsigned>(chunks < cap ? chunks : cap);
  k4_histogram<<<blocks, kHistThreads, 0, s>>>(
      p, static_cast<uint32_t>(n), pl, words + status_words(n) + kMaxPasses);
  return static_cast<int>(cudaGetLastError());
}

// K4: pass `pass` of the plan radix_histogram counted: one stable LSD pass
// by digit (in[widx] >> shift) & (2^bits - 1) of n_planes uint32 planes of
// n elements from in0..3 into out0..3 (distinct buffers), through the
// same scratch.
int radix_pass(const void* in0, const void* in1, const void* in2,
               const void* in3, void* out0, void* out1, void* out2, void* out3,
               int n_planes, long long n, int widx, int shift, int bits,
               int pass, void* scratch, long long scratch_words, void* stream) {
  if (bad_shape(n_planes, n) || bad_digit(widx, n_planes, shift, bits) ||
      pass < 0 || pass >= kMaxPasses ||
      scratch_words < scratch_words_for(n, pass + 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes p{};
  const void* ins[kMaxPlanes] = {in0, in1, in2, in3};
  void* outs[kMaxPlanes] = {out0, out1, out2, out3};
  for (int q = 0; q < n_planes; ++q) {
    p.in[q] = static_cast<const uint32_t*>(ins[q]);
    p.out[q] = static_cast<uint32_t*>(outs[q]);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* words = static_cast<uint32_t*>(scratch);
  unsigned long long* status = reinterpret_cast<unsigned long long*>(words);
  uint32_t* counter = words + status_words(n) + pass;
  const uint32_t* hist =
      words + status_words(n) + kMaxPasses + static_cast<size_t>(pass) * kBins;
  const cudaError_t attr = allow_smem(k4_onesweep, kOnesweepDynSmem, g_onesweep_smem);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  k4_onesweep<<<static_cast<unsigned>(tiles_for(n)), kThreads, kOnesweepDynSmem, s>>>(
      p, n_planes, widx, static_cast<uint32_t>(n), shift, bits, hist, status,
      counter, static_cast<unsigned long long>(pass) + 1);
  return static_cast<int>(cudaGetLastError());
}

// The digit sort's count (digit_count): clears `counts` (kCountHead +
// 2 * 2^bits words) and, when given, the scatter passes' `status`
// (status_words 32-bit words, at least sweep_status_words(n)), then
// counts the digit (key >> shift) & (2^key_bits - 1) of the n keys of the
// uint32 plane `key` into 2^bits bins (a digit of 2^bits or more counts in
// none) and the scatter passes' histograms, the first pass taking the low
// low_bits bits and the second, when key_bits > low_bits, the rest.
int digit_count(const void* key, long long n, int shift, int key_bits,
                int bits, int low_bits, void* counts, void* status,
                long long status_words, void* stream) {
  if (n < 1 || n >= (1LL << 31) || bits < 1 || bits > kDigitMaxBits ||
      shift < 0 || key_bits < 1 || key_bits > bits + 1 || shift + key_bits > 32 ||
      low_bits < 1 || low_bits > kSweepBits || low_bits > key_bits ||
      key_bits - low_bits > kSweepBits ||
      (status != nullptr && status_words < sweep_status_words(n))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t nb = size_t{1} << bits;
  cudaError_t err = cudaMemsetAsync(counts, 0, (kCountHead + 2 * nb) * 4, s);
  if (err == cudaSuccess && status != nullptr) {
    err = cudaMemsetAsync(status, 0, static_cast<size_t>(status_words) * 4, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = nb / 2 * 4;
  err = allow_smem(k4_digit_count, (size_t{1} << kDigitMaxBits) / 2 * 4, g_count_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long rounds = (n + kCountRound - 1) / kCountRound;
  const long long cap = sm_count();  // one block an SM, each its own counters
  const unsigned blocks = static_cast<unsigned>(rounds < cap ? rounds : cap);
  const uint32_t* key_words = static_cast<const uint32_t*>(key);
  uint32_t n_keys = static_cast<uint32_t>(n);
  uint32_t* count_words = static_cast<uint32_t*>(counts);
  void* args[] = {&key_words, &n_keys, &shift, &key_bits, &bits, &low_bits, &count_words};
  // cooperative: every block resident, so the kernel's grid barriers end
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(k4_digit_count), dim3(blocks),
                                    dim3(kCountThreads), args, smem, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// One scatter pass of the digit sort (digit_scatter), pass 0 or 1 of the
// count before it: a stable pass by digit (in[widx] >> shift) & (2^bits -
// 1), bits <= kSweepBits, of n_planes uint32 planes of n elements from
// in0..3 into out0..3 (distinct buffers), through that count's `counts`
// (its pass histograms and tile counters) and `status`.
int digit_scatter(const void* in0, const void* in1, const void* in2,
                  const void* in3, void* out0, void* out1, void* out2,
                  void* out3, int n_planes, long long n, int widx, int shift,
                  int bits, int pass, void* counts, void* status,
                  long long status_words, void* stream) {
  if (bad_shape(n_planes, n) || bad_digit(widx, n_planes, shift, bits, kSweepBits) ||
      pass < 0 || pass > 1 || status_words < sweep_status_words(n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Planes p{};
  const void* ins[kMaxPlanes] = {in0, in1, in2, in3};
  void* outs[kMaxPlanes] = {out0, out1, out2, out3};
  for (int q = 0; q < n_planes; ++q) {
    p.in[q] = static_cast<const uint32_t*>(ins[q]);
    p.out[q] = static_cast<uint32_t*>(outs[q]);
  }
  uint32_t* words = static_cast<uint32_t*>(counts);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      bits <= kMaxBits
          ? launch_scatter<kMaxBits>(p, n_planes, widx, n, shift, bits, pass, words,
                                     status, s, g_scatter8_smem)
          : launch_scatter<kSweepBits>(p, n_planes, widx, n, shift, bits, pass, words,
                                       status, s, g_scatter9_smem));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
