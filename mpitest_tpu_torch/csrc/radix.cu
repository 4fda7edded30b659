// Fused LSD radix pass for Hopper (sm_90a).
//
// Replaces the Pallas kernel of mpitest_tpu/ops/radix_pallas.py on the
// radix_pallas local-sort path:
//
//   K4 radix_pass  <- _pass_kernel behind _fused_pass (the pallas_call of
//                     fused_radix_sort, radix_pallas.py:186)
//
// One call is one planned pass (word widx, bit shift, digit width bits
// <= 8): the digit (w[widx] >> shift) & (2^bits - 1), taken on uint32
// words, a histogram over the 2^bits bins, its exclusive prefix, and a
// STABLE scatter of every word plane (up to four) from `in` to `out`.
// The reference pads to a multiple of its 512-row chunk and bins the pads
// by index into an extra bin; this pass works on the n real rows only,
// which gives the same first n rows.
//
// Three launches per pass, all on the caller's stream, no host sync:
//   1. tile_histogram: per 8192-element tile, a digit histogram in shared
//      memory (warp-aggregated: the lanes of one digit find each other
//      with one ballot per digit bit, and only the lowest adds, so an
//      all-equal tile costs one shared atomic per warp step), written
//      bin-major to hist[b * n_tiles + tile];
//   2. row_scan: one block per bin scans its row of tile counts in place
//      (exclusive) and writes the bin's total to totals[b];
//   3. scatter_tile: per tile, each warp owns 512 contiguous elements and
//      counts its digits (ballots); the warps' counts are combined in
//      warp order through shared memory; the warp then walks its elements
//      again in order, ranking each among equal digits of its 32-element
//      step (popc of the lower peers), which gives every element its slot
//      in the tile sorted stably by digit.  The tile is reordered in
//      shared memory and written out slot by slot, so each digit's
//      elements leave as one contiguous run at the bin's global base
//      (exclusive prefix of the totals plus the tile's row prefix); the
//      other planes follow through the same slots.
//
// Bound on the H100: HBM bytes.  The pass must read every plane once and
// write it once; this design reads the digit plane a second time (for the
// histogram) and adds the tile table (256 words per 8192 elements, ~3% of
// one plane).  Writing each tile in sorted order turns the scatter into
// runs of ~32 words per digit (uniform keys) instead of one word per
// digit per warp step.  One launch per pass with decoupled look-back
// (onesweep) is the next step.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 4;
constexpr int kMaxBits = 8;
constexpr int kMaxBins = 1 << kMaxBits;
constexpr int kThreads = 512;                  // histogram and scatter blocks
constexpr int kWarps = kThreads / 32;
constexpr int kItems = 16;                     // elements per lane per tile
constexpr int kWarpSpan = 32 * kItems;         // contiguous elements per warp
constexpr int kTile = kWarps * kWarpSpan;      // 8192 elements per tile
constexpr int kScanThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kMaxBins <= kThreads, "scatter_tile gives each bin one thread");

struct Planes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
};

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

__device__ __forceinline__ bool is_leader(unsigned peers, unsigned lane) {
  return static_cast<unsigned>(__ffs(peers) - 1) == lane;
}

// Lanes of the warp whose (valid, digit) equals this lane's: one ballot
// per digit bit and one for validity.  Its cost does not depend on how
// many distinct digits the warp holds.
__device__ __forceinline__ unsigned peers_of(uint32_t d, bool valid, int bits) {
  const unsigned v = __ballot_sync(kFull, valid);
  unsigned peers = valid ? v : ~v;
#pragma unroll
  for (int b = 0; b < kMaxBits; ++b) {
    if (b < bits) {
      const bool set = (d >> b) & 1u;
      const unsigned m = __ballot_sync(kFull, set);
      peers &= set ? m : ~m;
    }
  }
  return peers;
}

__global__ void __launch_bounds__(kThreads)
tile_histogram(const uint32_t* __restrict__ w, uint32_t n, int shift,
               int bits, uint32_t* __restrict__ hist, uint32_t n_tiles) {
  const int bins = 1 << bits;
  const uint32_t mask = static_cast<uint32_t>(bins - 1);
  __shared__ uint32_t h[kMaxBins];
  for (int b = threadIdx.x; b < bins; b += blockDim.x) h[b] = 0;
  __syncthreads();
  const size_t base = static_cast<size_t>(blockIdx.x) * kTile;
  const unsigned lane = threadIdx.x & 31;
  uint32_t v[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const size_t e = base + static_cast<size_t>(i) * kThreads + threadIdx.x;
    v[i] = e < n ? w[e] : 0u;
  }
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const size_t e = base + static_cast<size_t>(i) * kThreads + threadIdx.x;
    const bool valid = e < n;
    // invalid lanes group with each other, never with a real digit, and
    // count nowhere
    const uint32_t d = (v[i] >> shift) & mask;
    const unsigned peers = peers_of(d, valid, bits);
    if (valid && is_leader(peers, lane)) {
      atomicAdd(&h[d], static_cast<uint32_t>(__popc(peers)));
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += blockDim.x) {
    hist[static_cast<size_t>(b) * n_tiles + blockIdx.x] = h[b];
  }
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

__global__ void __launch_bounds__(kScanThreads)
row_scan(uint32_t* __restrict__ hist, uint32_t n_tiles,
         uint32_t* __restrict__ totals) {
  constexpr int kScanWarps = kScanThreads / 32;
  static_assert(kScanWarps == 32, "one warp scans the warp sums");
  __shared__ uint32_t warp_sums[kScanWarps];
  uint32_t* row = hist + static_cast<size_t>(blockIdx.x) * n_tiles;
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = threadIdx.x >> 5;
  uint32_t carry = 0;
  for (uint32_t c0 = 0; c0 < n_tiles; c0 += kScanThreads) {
    const uint32_t i = c0 + threadIdx.x;
    const uint32_t v = i < n_tiles ? row[i] : 0u;
    const uint32_t x = warp_inclusive(v, lane);
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) warp_sums[lane] = warp_inclusive(warp_sums[lane], lane);
    __syncthreads();
    if (i < n_tiles) row[i] = carry + (warp ? warp_sums[warp - 1] : 0u) + x - v;
    carry += warp_sums[kScanWarps - 1];
    __syncthreads();  // warp_sums is rewritten by the next chunk
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// Dynamic shared memory of scatter_tile: the tile's values in sorted
// order (one plane at a time) and each sorted slot's digit.
constexpr size_t kScatterDynSmem = kTile * sizeof(uint32_t) + kTile;

__global__ void __launch_bounds__(kThreads)
scatter_tile(Planes p, int n_planes, int widx, uint32_t n, int shift,
             int bits, const uint32_t* __restrict__ hist, uint32_t n_tiles,
             const uint32_t* __restrict__ totals) {
  const int bins = 1 << bits;
  const uint32_t mask = static_cast<uint32_t>(bins - 1);
  extern __shared__ uint32_t dyn[];
  uint32_t* buf = dyn;                                      // kTile values
  uint8_t* dig = reinterpret_cast<uint8_t*>(dyn + kTile);   // kTile digits
  __shared__ uint32_t local_start[kMaxBins];  // tile-local first slot of bin
  __shared__ uint32_t out_base[kMaxBins];     // global slot of local slot 0
  __shared__ uint32_t warp_off[kWarps][kMaxBins];
  const unsigned lane = threadIdx.x & 31;
  const unsigned warp = threadIdx.x >> 5;
  const size_t tile_base = static_cast<size_t>(blockIdx.x) * kTile;
  const uint32_t tile_n = static_cast<uint32_t>(
      n - tile_base < static_cast<size_t>(kTile) ? n - tile_base : kTile);

  for (int b = lane; b < kMaxBins; b += 32) warp_off[warp][b] = 0;

  // phase A: this warp's digit counts over its 512 contiguous elements
  const size_t wbase = tile_base + static_cast<size_t>(warp) * kWarpSpan;
  const uint32_t* key_in = p.in[widx];
  uint32_t key[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const size_t e = wbase + static_cast<size_t>(i) * 32 + lane;
    key[i] = e < n ? key_in[e] : 0u;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const size_t e = wbase + static_cast<size_t>(i) * 32 + lane;
    const bool valid = e < n;
    const uint32_t d = (key[i] >> shift) & mask;
    const unsigned peers = peers_of(d, valid, bits);
    if (valid && is_leader(peers, lane)) warp_off[warp][d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();

  // warps combined in order: warp w's first slot for bin b, relative to
  // the bin's tile-local start, is the count of warps 0..w-1
  if (threadIdx.x < static_cast<unsigned>(bins)) {
    const int b = threadIdx.x;
    uint32_t run = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t c = warp_off[w][b];
      warp_off[w][b] = run;
      run += c;
    }
    local_start[b] = run;  // the tile's count of bin b, scanned below
  }
  __syncthreads();

  // warp 0: bins' tile-local starts (scan of the tile's counts) and their
  // global bases (scan of the totals plus this tile's row prefix)
  if (warp == 0) {
    constexpr int kPer = kMaxBins / 32;
    uint32_t cnt[kPer];
    uint32_t tot[kPer];
    uint32_t sc = 0, st = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int b = lane * kPer + j;
      cnt[j] = b < bins ? local_start[b] : 0u;
      tot[j] = b < bins ? totals[b] : 0u;
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
        // modular: out_base[b] + slot is exact for every slot of bin b
        out_base[b] = rt + hist[static_cast<size_t>(b) * n_tiles + blockIdx.x] - rc;
      }
      rc += cnt[j];
      rt += tot[j];
    }
  }
  __syncthreads();

  // phase B: the same elements in the same order take their tile-local
  // sorted slots (rank among equal digits of the step, lower lanes
  // first), so the tile is stably sorted in shared memory
  uint32_t slot[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const size_t e = wbase + static_cast<size_t>(i) * 32 + lane;
    const bool valid = e < n;
    const uint32_t d = (key[i] >> shift) & mask;
    const unsigned peers = peers_of(d, valid, bits);
    slot[i] = valid ? local_start[d] + warp_off[warp][d] + __popc(peers & lanemask_lt())
                    : 0u;
    __syncwarp();
    if (valid && is_leader(peers, lane)) warp_off[warp][d] += __popc(peers);
    __syncwarp();
    if (valid) {
      buf[slot[i]] = key[i];
      dig[slot[i]] = static_cast<uint8_t>(d);
    }
  }
  __syncthreads();

  // write out in sorted order: consecutive slots of one digit go to
  // consecutive global addresses; the other planes follow the same slots
  for (uint32_t j = threadIdx.x; j < tile_n; j += kThreads) {
    p.out[widx][out_base[dig[j]] + j] = buf[j];
  }
#pragma unroll
  for (int q = 0; q < kMaxPlanes; ++q) {
    if (q >= n_planes || q == widx) continue;
    __syncthreads();  // buf is free again
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      const size_t e = wbase + static_cast<size_t>(i) * 32 + lane;
      if (e < n) buf[slot[i]] = p.in[q][e];
    }
    __syncthreads();
    for (uint32_t j = threadIdx.x; j < tile_n; j += kThreads) {
      p.out[q][out_base[dig[j]] + j] = buf[j];
    }
  }
}

unsigned tiles_for(long long n) {
  return static_cast<unsigned>((n + kTile - 1) / kTile);
}

}  // namespace

extern "C" {

// Words of the `hist` scratch radix_pass needs for n elements.
long long radix_hist_words(long long n) {
  return static_cast<long long>(kMaxBins) * tiles_for(n);
}

// K4: one stable LSD pass by digit (in[widx] >> shift) & (2^bits - 1) of
// n_planes uint32 planes of n elements from in0..3 into out0..3 (distinct
// buffers); hist holds radix_hist_words(n) words and totals 256.
int radix_pass(const void* in0, const void* in1, const void* in2,
               const void* in3, void* out0, void* out1, void* out2, void* out3,
               int n_planes, long long n, int widx, int shift, int bits,
               void* hist, void* totals, void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || widx < 0 || widx >= n_planes ||
      bits < 1 || bits > kMaxBits || shift < 0 || shift + bits > 32 || n < 1 ||
      n >= (1LL << 31)) {
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
  const unsigned n_tiles = tiles_for(n);
  const int bins = 1 << bits;
  const uint32_t nn = static_cast<uint32_t>(n);
  uint32_t* h = static_cast<uint32_t*>(hist);
  uint32_t* t = static_cast<uint32_t*>(totals);
  tile_histogram<<<n_tiles, kThreads, 0, s>>>(p.in[widx], nn, shift, bits, h,
                                              n_tiles);
  row_scan<<<bins, kScanThreads, 0, s>>>(h, n_tiles, t);
  const cudaError_t attr = cudaFuncSetAttribute(
      scatter_tile, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kScatterDynSmem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  scatter_tile<<<n_tiles, kThreads, kScatterDynSmem, s>>>(
      p, n_planes, widx, nn, shift, bits, h, n_tiles, t);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
