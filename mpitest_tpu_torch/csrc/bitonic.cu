// Bitonic sort network and 64-bit run fix-up for Hopper (sm_90a).
//
// Replaces the Pallas kernels of mpitest_tpu/ops/bitonic.py on the
// single-device sort path:
//
//   K1 bitonic_u32        <- _block_sort_kernel, _merge_kernel,
//                            _relayout_cross_kernel, _rot_merge_kernel
//                            (driven by sort_padded / bitonic_sort_u32)
//   K2 bitonic_pairs_u32  <- _block_sort_pair_kernel, _merge_pair_kernel,
//                            _relayout_cross_pair_kernel,
//                            _rot_merge_pair_kernel (sort_pairs_padded)
//   K3 fix_runs_pairs     <- _fix_runs_pair_kernel (fix_runs_pairs)
//
// What is ported is the computation, not the TPU schedule: the standard
// bitonic network over the whole power-of-two array.  Stage m (1..t)
// compare-exchanges i with i ^ 2^j for j = m-1 .. 0, ascending where bit
// m of the global index i is 0 -- the directions _block_sort_kernel
// derives from the flat index.  The pair form moves the payload with
// the key result (bitonic.py:62-66): a position keeps its payload iff its
// key is unchanged, so ties keep their own and the network swaps a pair
// exactly when the keys differ in the wrong order.
//
// Bound on the H100: HBM bytes.  Every pass that goes through global
// memory reads and writes the array once, so the passes, not the
// compares, set the time: at 2^28 keys one pass moves 2 GiB (0.64 ms at
// 3.35 TB/s).  Design against that bound:
//   (a) tile_network sorts a shared-memory tile of 2^14 keys (2^13
//       pairs) per CUDA block: all stages up to the tile size in one
//       global read + write;
//   (b) global_layers applies up to five consecutive layers of one stage
//       whose distance is at least the tile, each thread holding 32
//       elements in registers, so one global pass retires five layers;
//   (c) tile_network again for each later stage's in-tile tail (the
//       layers below the tile size) in one more global pass.
// At 2^28 keys that is 27 global passes plus 15 tile passes (27 ms of
// HBM traffic) instead of the 406 layers of the network.  Inside a tile the same register trick
// retires four layers per shared-memory round (tile_round), so a barrier
// and a shared-memory sweep serve four layers, not one; a pad word per 32
// keeps the rounds' power-of-two strides off a single bank; and each
// thread issues 16 tile loads before its first store, since a tile pass
// with one load in flight per thread waits on HBM latency, not bandwidth.
//
// K3 runs `passes` segment-masked odd-even transposition passes inside
// each `bsz` block (lo sorted within runs of equal hi; the block's last
// element pairs with nothing).  A CUDA block owns a 2^12 chunk plus a
// halo of 32 on each side (clipped at the bsz block edges) in shared
// memory: an odd-even pass moves information one position, so with
// passes <= 32 the chunk's values equal those of the whole-block
// computation.  One global read of hi and lo and one write of lo.
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kKeyTileLog2 = 14;    // K1 tile: 64 KiB (+ pad) of shared memory
constexpr int kPairTileLog2 = 13;   // K2 tile: two planes, 64 KiB (+ pad)
constexpr int kTileThreads = 512;
constexpr int kTileRound = 4;       // layers per shared-memory round
constexpr int kLoadBatch = 16;      // global loads in flight per thread
constexpr int kLayerThreads = 256;
constexpr int kMaxFusedLayers = 5;  // layers per global pass
constexpr int kFixChunkLog2 = 12;
constexpr int kFixHalo = 32;
constexpr int kFixThreads = 512;
// the dispatch switches below name every layer count 1..kTileRound and
// 1..kMaxFusedLayers; a larger constant needs more cases there
static_assert(kTileRound == 4, "tile_network dispatches rounds of 1..4 layers");
static_assert(kMaxFusedLayers == 5, "run_network dispatches passes of 1..5 layers");

template <bool kPair>
__device__ __forceinline__ void exchange(uint32_t& a, uint32_t& b,
                                         uint32_t& pa, uint32_t& pb,
                                         bool asc) {
  const bool swap = asc ? (a > b) : (a < b);
  if (swap) {
    const uint32_t t = a; a = b; b = t;
    if (kPair) { const uint32_t u = pa; pa = pb; pb = u; }
  }
}

// Shared-memory slot of tile element i: one pad word per 32 spreads the
// power-of-two strides of a register round over the 32 banks.
__device__ __forceinline__ unsigned slot(unsigned i) { return i + (i >> 5); }

// Layers j, j-1, ..., j-R+1 of stage m over one shared-memory tile whose
// first element has global index gbase: each group of 2^R elements (index
// bits j-R+1..j varying) is loaded into registers, run through the R
// layers, and stored back; a barrier ends the round.
template <bool kPair, int R>
__device__ __forceinline__ void tile_round(uint32_t* sk, uint32_t* sp,
                                           unsigned tile, size_t gbase,
                                           int j, int m) {
  constexpr int E = 1 << R;
  const int low = j - R + 1;
  const unsigned stride = 1u << low;
  for (unsigned g = threadIdx.x; g < (tile >> R); g += blockDim.x) {
    const unsigned base = ((g >> low) << (j + 1)) | (g & (stride - 1));
    const bool asc = (((gbase + base) >> m) & 1) == 0;
    uint32_t kk[E];
    uint32_t pp[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      kk[r] = sk[slot(base + r * stride)];
      pp[r] = kPair ? sp[slot(base + r * stride)] : 0u;
    }
#pragma unroll
    for (int b = R - 1; b >= 0; --b) {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        if (r & (1 << b)) continue;
        exchange<kPair>(kk[r], kk[r | (1 << b)], pp[r], pp[r | (1 << b)], asc);
      }
    }
#pragma unroll
    for (int r = 0; r < E; ++r) {
      sk[slot(base + r * stride)] = kk[r];
      if (kPair) sp[slot(base + r * stride)] = pp[r];
    }
  }
  __syncthreads();
}

// Stages m_lo..m_hi of the network restricted to one tile of 2^tl
// elements: for each stage the layers min(m, tl)-1 .. 0, kTileRound at a
// time.  With m_lo = 1, m_hi = tl this is the block sort; with
// m_lo = m_hi = m > tl it is the in-tile tail of stage m.  May run in
// place (kin == kout).
template <bool kPair>
__global__ void __launch_bounds__(kTileThreads, 2)
tile_network(const uint32_t* kin, const uint32_t* pin, uint32_t* kout,
             uint32_t* pout, int tl, int m_lo, int m_hi) {
  extern __shared__ uint32_t smem[];
  const unsigned tile = 1u << tl;
  uint32_t* sk = smem;
  uint32_t* sp = smem + slot(tile);
  const size_t gbase = static_cast<size_t>(blockIdx.x) << tl;
  // kLoadBatch loads in flight per thread (and plane) before the first
  // shared-memory store: one at a time leaves HBM waiting on latency
  for (unsigned e0 = threadIdx.x; e0 < tile; e0 += blockDim.x * kLoadBatch) {
    uint32_t vk[kLoadBatch];
    uint32_t vp[kLoadBatch];
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const unsigned e = e0 + u * blockDim.x;
      vk[u] = e < tile ? kin[gbase + e] : 0u;
      vp[u] = kPair && e < tile ? pin[gbase + e] : 0u;
    }
#pragma unroll
    for (int u = 0; u < kLoadBatch; ++u) {
      const unsigned e = e0 + u * blockDim.x;
      if (e < tile) {
        sk[slot(e)] = vk[u];
        if (kPair) sp[slot(e)] = vp[u];
      }
    }
  }
  __syncthreads();
  for (int m = m_lo; m <= m_hi; ++m) {
    for (int j = (m < tl ? m : tl) - 1; j >= 0;) {
      const int r = j + 1 < kTileRound ? j + 1 : kTileRound;
      switch (r) {
        case 1: tile_round<kPair, 1>(sk, sp, tile, gbase, j, m); break;
        case 2: tile_round<kPair, 2>(sk, sp, tile, gbase, j, m); break;
        case 3: tile_round<kPair, 3>(sk, sp, tile, gbase, j, m); break;
        default: tile_round<kPair, kTileRound>(sk, sp, tile, gbase, j, m); break;
      }
      j -= r;
    }
  }
  for (unsigned e = threadIdx.x; e < tile; e += blockDim.x) {
    kout[gbase + e] = sk[slot(e)];
    if (kPair) pout[gbase + e] = sp[slot(e)];
  }
}

// Layers j, j-1, ..., j-R+1 of stage m in one global pass.  Thread c owns
// the 2^R elements whose index bits j-R+1..j run over all values and whose
// other bits come from c; all of them share bit m (m > j), so one
// direction serves the whole group.
template <bool kPair, int R>
__global__ void global_layers(uint32_t* k, uint32_t* p, size_t n, int j,
                              int m) {
  constexpr int E = 1 << R;
  const size_t c = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (c >= (n >> R)) return;
  const int low = j - R + 1;
  const size_t stride = static_cast<size_t>(1) << low;
  const size_t base = ((c >> low) << (j + 1)) | (c & (stride - 1));
  const bool asc = ((base >> m) & 1) == 0;
  uint32_t kk[E];
  uint32_t pp[E];
#pragma unroll
  for (int r = 0; r < E; ++r) {
    kk[r] = k[base + r * stride];
    pp[r] = kPair ? p[base + r * stride] : 0u;
  }
#pragma unroll
  for (int b = R - 1; b >= 0; --b) {
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (r & (1 << b)) continue;
      exchange<kPair>(kk[r], kk[r | (1 << b)], pp[r], pp[r | (1 << b)], asc);
    }
  }
#pragma unroll
  for (int r = 0; r < E; ++r) {
    k[base + r * stride] = kk[r];
    if (kPair) p[base + r * stride] = pp[r];
  }
}

template <bool kPair, int R>
void launch_layers(uint32_t* k, uint32_t* p, size_t n, int j, int m,
                   cudaStream_t s) {
  const size_t threads = n >> R;
  const unsigned blocks =
      static_cast<unsigned>((threads + kLayerThreads - 1) / kLayerThreads);
  global_layers<kPair, R><<<blocks, kLayerThreads, 0, s>>>(k, p, n, j, m);
}

int log2_exact(long long n) {
  if (n <= 0 || (n & (n - 1)) != 0) return -1;
  int t = 0;
  while ((1LL << t) < n) ++t;
  return t;
}

template <bool kPair>
int run_network(const uint32_t* kin, const uint32_t* pin, uint32_t* k,
                uint32_t* p, long long n, cudaStream_t s, int tile_log2) {
  const int t = log2_exact(n);
  if (t < 0 || t > 31) return static_cast<int>(cudaErrorInvalidValue);
  const int tl = t < tile_log2 ? t : tile_log2;
  const unsigned tile = 1u << tl;
  const size_t smem = static_cast<size_t>(tile + (tile >> 5)) * sizeof(uint32_t) *
                      (kPair ? 2 : 1);
  const cudaError_t attr = cudaFuncSetAttribute(
      tile_network<kPair>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const unsigned threads = tile / 2 < kTileThreads ? (tile / 2 > 0 ? tile / 2 : 1)
                                                   : kTileThreads;
  const unsigned tiles = static_cast<unsigned>(n >> tl);
  tile_network<kPair><<<tiles, threads, smem, s>>>(kin, pin, k, p, tl, 1, tl);
  for (int m = tl + 1; m <= t; ++m) {
    int j = m - 1;
    while (j >= tl) {
      const int r = (j - tl + 1) < kMaxFusedLayers ? (j - tl + 1) : kMaxFusedLayers;
      switch (r) {
        case 1: launch_layers<kPair, 1>(k, p, n, j, m, s); break;
        case 2: launch_layers<kPair, 2>(k, p, n, j, m, s); break;
        case 3: launch_layers<kPair, 3>(k, p, n, j, m, s); break;
        case 4: launch_layers<kPair, 4>(k, p, n, j, m, s); break;
        default: launch_layers<kPair, kMaxFusedLayers>(k, p, n, j, m, s); break;
      }
      j -= r;
    }
    tile_network<kPair><<<tiles, threads, smem, s>>>(k, p, k, p, tl, m, m);
  }
  return static_cast<int>(cudaGetLastError());
}

__global__ void fix_runs_kernel(const uint32_t* __restrict__ hi,
                                const uint32_t* __restrict__ lo,
                                uint32_t* __restrict__ out, int passes,
                                int bsz_log2, int chunk_log2) {
  __shared__ uint32_t sh[(1 << kFixChunkLog2) + 2 * kFixHalo];
  __shared__ uint32_t sl[(1 << kFixChunkLog2) + 2 * kFixHalo];
  const size_t chunk = static_cast<size_t>(1) << chunk_log2;
  const size_t c0 = static_cast<size_t>(blockIdx.x) << chunk_log2;
  const size_t b0 = (c0 >> bsz_log2) << bsz_log2;
  const size_t b1 = b0 + (static_cast<size_t>(1) << bsz_log2);
  const size_t w0 = c0 >= b0 + kFixHalo ? c0 - kFixHalo : b0;
  const size_t w1 = c0 + chunk + kFixHalo <= b1 ? c0 + chunk + kFixHalo : b1;
  const int len = static_cast<int>(w1 - w0);
  for (int e = threadIdx.x; e < len; e += blockDim.x) {
    sh[e] = hi[w0 + e];
    sl[e] = lo[w0 + e];
  }
  __syncthreads();
  const int par0 = static_cast<int>(w0 & 1);
  for (int t = 0; t < passes; ++t) {
    // pairs (e, e+1) whose left element has global parity t & 1; the
    // window's last element pairs with nothing
    const int first = (t & 1) ^ par0;
    for (int e = first + 2 * static_cast<int>(threadIdx.x); e + 1 < len;
         e += 2 * static_cast<int>(blockDim.x)) {
      const uint32_t a = sl[e], b = sl[e + 1];
      if (sh[e] == sh[e + 1] && a > b) {
        sl[e] = b;
        sl[e + 1] = a;
      }
    }
    __syncthreads();
  }
  const int off = static_cast<int>(c0 - w0);
  for (int e = threadIdx.x; e < static_cast<int>(chunk); e += blockDim.x) {
    out[c0 + e] = sl[off + e];
  }
}

}  // namespace

extern "C" {

// K1: sort n_pow2 uint32 keys ascending from `in` into `out` (may alias).
int bitonic_u32(const void* in, void* out, long long n_pow2, void* stream) {
  return run_network<false>(static_cast<const uint32_t*>(in), nullptr,
                            static_cast<uint32_t*>(out), nullptr, n_pow2,
                            static_cast<cudaStream_t>(stream), kKeyTileLog2);
}

// K2: sort (key, payload) pairs by key; payload follows its key.
int bitonic_pairs_u32(const void* kin, const void* pin, void* kout,
                      void* pout, long long n_pow2, void* stream) {
  return run_network<true>(static_cast<const uint32_t*>(kin),
                           static_cast<const uint32_t*>(pin),
                           static_cast<uint32_t*>(kout),
                           static_cast<uint32_t*>(pout), n_pow2,
                           static_cast<cudaStream_t>(stream), kPairTileLog2);
}

// K3: `passes` (<= 32) segment-masked odd-even passes of lo within runs of
// equal hi inside each bsz block; writes the new lo plane to `out`.
int fix_runs_pairs(const void* hi, const void* lo, void* out, long long n,
                   int passes, long long bsz, void* stream) {
  const int bl = log2_exact(bsz);
  if (bl < 1 || log2_exact(n) < bl || passes < 0 || passes > kFixHalo) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int cl = bl < kFixChunkLog2 ? bl : kFixChunkLog2;
  const unsigned blocks = static_cast<unsigned>(n >> cl);
  fix_runs_kernel<<<blocks, kFixThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
      static_cast<uint32_t*>(out), passes, bl, cl);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
