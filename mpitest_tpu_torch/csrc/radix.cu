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
// Every entry point launches on the caller's stream, and returns
// cudaGetLastError() (0 on success); none allocates.

#include <atomic>
#include <cstdint>
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
constexpr uint32_t kInvalidDigit = kBins;      // groups the lanes past n
constexpr unsigned long long kFlagAggregate = 1ull << 32;
constexpr unsigned long long kFlagInclusive = 2ull << 32;
constexpr int kEpochShift = 34;
static_assert(kBins <= kThreads, "one thread per bin");

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
// the digit's 9 (bits above a narrow digit are 0 in every key; bit
// kMaxBits is set only in kInvalidDigit, the digit of the lanes past n,
// so they group with each other and never with a key).
__device__ __forceinline__ unsigned peers_of(uint32_t d) {
  unsigned peers = kFull;
#pragma unroll
  for (int b = 0; b <= kMaxBits; ++b) {
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

// Dynamic shared memory of k4_onesweep: the tile's values in sorted order
// (one plane at a time), each key's sorted slot (in key order), and each
// sorted slot's digit.
constexpr size_t kOnesweepDynSmem =
    kTile * sizeof(uint32_t) + kTile * sizeof(uint16_t) + kTile;
static_assert(kTile <= 65536, "tile-local slots are 16-bit");

__global__ void __launch_bounds__(kThreads, kMinBlocks)
k4_onesweep(Planes p, int n_planes, int widx, uint32_t n, int shift, int bits,
            const uint32_t* __restrict__ hist, unsigned long long* status,
            uint32_t* counter, unsigned long long epoch) {
  const int bins = 1 << bits;
  const uint32_t mask = static_cast<uint32_t>(bins - 1);
  extern __shared__ uint32_t dyn[];
  uint32_t* buf = dyn;                                           // kTile values
  uint16_t* slot_of = reinterpret_cast<uint16_t*>(dyn + kTile);  // kTile slots
  uint8_t* dig = reinterpret_cast<uint8_t*>(slot_of + kTile);    // kTile digits
  __shared__ uint32_t warp_off[kWarps][kBins];  // warp counts, then starts
  __shared__ uint32_t tile_count[kBins];
  __shared__ uint32_t local_start[kBins];      // tile-local first slot of bin
  __shared__ uint32_t bin_base[kBins];         // the pass's first slot of bin
  __shared__ uint32_t out_base[kBins];         // global slot of local slot 0
  __shared__ uint32_t tile_index;
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = threadIdx.x >> 5;

  if (threadIdx.x == 0) tile_index = atomicAdd(counter, 1u);
  for (int b = lane; b < kBins; b += 32) warp_off[warp][b] = 0;
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
    const uint32_t d = valid ? (key[i] >> shift) & mask : kInvalidDigit;
    const unsigned peers = peers_of(d);
    const uint32_t below = __popc(peers & lanemask_lt());
    const uint32_t seen = valid ? warp_off[warp][d] : 0u;
    __syncwarp();
    if (valid && below == 0) warp_off[warp][d] = seen + __popc(peers);
    __syncwarp();
    rank[i] = seen + below;
  }
  __syncthreads();

  // warps combined in order; the tile's count of each bin is published
  // at once, so later tiles can look past this one
  unsigned long long* mine = status + static_cast<size_t>(tile) * kBins + threadIdx.x;
  const unsigned long long tag = epoch << kEpochShift;
  if (threadIdx.x < static_cast<unsigned>(bins)) {
    const int b = threadIdx.x;
    uint32_t run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_off[w][b];
      warp_off[w][b] = run;
      run += c;
    }
    tile_count[b] = run;
    store_status(mine, tag | (tile == 0 ? kFlagInclusive : kFlagAggregate) | run);
  }
  __syncthreads();

  // warp 0: bins' tile-local starts (scan of the tile's counts) and their
  // bases in the pass (scan of the pass's histogram)
  if (warp == 0) {
    constexpr int kPer = kBins / 32;
    uint32_t cnt[kPer];
    uint32_t tot[kPer];
    uint32_t sc = 0, st = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = lane * kPer + j;
      cnt[j] = b < bins ? tile_count[b] : 0u;
      tot[j] = b < bins ? hist[b] : 0u;
      sc += cnt[j];
      st += tot[j];
    }
    uint32_t rc = warp_inclusive(sc, lane) - sc;
    uint32_t rt = warp_inclusive(st, lane) - st;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = lane * kPer + j;
      if (b < bins) {
        local_start[b] = rc;
        bin_base[b] = rt;
      }
      rc += cnt[j];
      rt += tot[j];
    }
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
      dig[slot] = static_cast<uint8_t>(d);
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
      const unsigned long long* prev = mine - kBins;
      uint32_t left = tile;  // tiles before prev's, prev's included
      bool done = false;
      while (!done) {
        unsigned long long st[kLookAhead];
#pragma unroll
        for (int j = 0; j < kLookAhead; ++j) {
          st[j] = static_cast<uint32_t>(j) < left ? load_status(prev - j * kBins) : 0ull;
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
        prev -= static_cast<size_t>(taken) * kBins;
        left -= taken;
      }
      store_status(mine, tag | kFlagInclusive | (prefix + tile_count[b]));
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

// Per-card facts every call needs, looked up once a card: the SM count
// (sizes the histogram grid) and whether k4_onesweep's dynamic shared
// memory limit is raised.  A race only repeats an idempotent lookup.
constexpr int kMaxDevices = 64;
std::atomic<int> g_sms[kMaxDevices];
std::atomic<bool> g_onesweep_smem[kMaxDevices];

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

cudaError_t allow_onesweep_smem() {
  int dev = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < kMaxDevices;
  if (cached && g_onesweep_smem[dev].load(std::memory_order_relaxed)) {
    return cudaSuccess;
  }
  const cudaError_t err = cudaFuncSetAttribute(
      k4_onesweep, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kOnesweepDynSmem));
  if (err == cudaSuccess && cached) {
    g_onesweep_smem[dev].store(true, std::memory_order_relaxed);
  }
  return err;
}

bool bad_shape(int n_planes, long long n) {
  return n_planes < 1 || n_planes > kMaxPlanes || n < 1 || n >= (1LL << 31);
}

bool bad_digit(int widx, int n_planes, int shift, int bits) {
  return widx < 0 || widx >= n_planes || bits < 1 || bits > kMaxBits ||
         shift < 0 || shift + bits > 32;
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
  const cudaError_t attr = allow_onesweep_smem();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  k4_onesweep<<<static_cast<unsigned>(tiles_for(n)), kThreads, kOnesweepDynSmem, s>>>(
      p, n_planes, widx, static_cast<uint32_t>(n), shift, bits, hist, status,
      counter, static_cast<unsigned long long>(pass) + 1);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
