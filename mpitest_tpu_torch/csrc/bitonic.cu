// Bitonic pair network, one-word tile sort + merge-path rounds, and the
// 64-bit run fix-up, for Hopper (sm_90a).
//
// Replaces the Pallas kernels of mpitest_tpu/ops/bitonic.py on the
// single-device sort path:
//
//   K1 bitonic_u32        <- bitonic.py:308 _block_sort_kernel, :351
//                            _cross_kernel, :371 _merge_kernel, :514
//                            _relayout_cross_kernel, :571 _rot_merge_kernel
//                            (sort_padded / bitonic_sort_u32)
//   K2 bitonic_pairs_u32  <- bitonic.py:703 _block_sort_pair_kernel, :737
//                            _cross_pair_kernel, :758 _merge_pair_kernel,
//                            :970 _relayout_cross_pair_kernel, :1038
//                            _rot_merge_pair_kernel (sort_pairs_padded)
//   K3 fix_runs_pairs     <- bitonic.py:1101 _fix_runs_pair_kernel
//
// Bound on the H100: HBM bytes.  The function's floor is one read and one
// write of every plane (2*4*n bytes for K1, 4*4*n for K2, 0.64 ms at 2^28
// keys or 2^27 pairs and 3.35 TB/s).  A schedule pays that again for every
// pass through global memory, so its passes set the time, as long as the
// compares stay out of shared-memory sweeps and barriers and each pass
// streams HBM in long runs.
//
// K2 keeps the standard bitonic network, comparator for comparator:
// stage m (1..t) compare-exchanges i with i ^ 2^j for j = m-1 .. 0,
// ascending where bit m of i is 0, and a position keeps its payload iff
// its key is unchanged (bitonic.py:62-66), so the payload order inside a
// run of equal keys is the network's own permutation.  The 64-bit caller
// reads that order (its residual flag), so K2 must stay this network.
// What changes is the schedule:
//   (a) k2_tile_sort sorts a tile of 2^13 pairs (64 KiB of shared memory,
//       512 threads, two blocks an SM): each warp copies its own 512 pairs
//       in with cp.async and starts without a block barrier; a thread
//       holds 16 pairs, 32 apart, so layers j < 5 are __shfl_xor_sync
//       exchanges and layers 5..8 register exchanges, and only layers
//       j >= 9 go through shared memory, four a round and one barrier;
//   (b) k2_staged_pass applies up to eight layers j .. j-R+1 of a stage
//       whose distance is at least the tile: a block gathers 2^R rows of
//       2^(14-R) consecutive pairs (row r at base + r 2^(j-R+1); 128 KiB,
//       cp.async), runs the R layers on the rows in shared memory, and
//       writes the rows back with 16-byte stores.  A stage's layers are
//       split evenly over its passes: HBM streams a row of 2^(14-R) pairs
//       at a rate that falls with its length (128 B rows ran at half the
//       rate of 1 KiB rows), so fewer layers a pass buy longer rows;
//   (c) k2_tail_pass applies a later stage's layers below the tile in one
//       more pass, with the schedule of (a).
// At 2^27 pairs that is 1 tile sort + 20 staged passes + 14 tails = 35
// passes (ops/bitonic.py network_plan), against 42 before.
//
// K1 sorts one plane with no payload, so any correct sort gives its bytes:
//   (a) k1_tile_sort: the schedule of K2's tile sort without payload, on
//       2^14 keys (512 threads, two blocks an SM), every tile ascending; a
//       thread holds 32 consecutive keys (16-byte vectors through shared
//       memory with four pad words per 32), so layers j < 5 are register
//       exchanges, 5..9 shuffles, and the first 15 layers need no shuffle;
//   (b) log2(n / 2^14) merge rounds, each one read and one write of the
//       array, ping-ponging between `out` and a scratch plane so the last
//       round lands in `out`.  k1_merge_partition finds each 8192-key
//       output window's start on the merge-path diagonal (binary search
//       over the two runs, A taken when a <= b); k1_merge_round copies the
//       window's two input spans into shared memory with 16-byte
//       cp.async, each thread finds its own diagonal there and merges 16
//       keys serially, and the block stores through shared memory with
//       16-byte writes.
// At 2^28 that is 1 + 14 = 15 passes (merge_rounds), against 42 before.
//
// K3 runs `passes` segment-masked odd-even transposition passes inside
// each `bsz` block (lo sorted within runs of equal hi; the block's last
// element pairs with nothing).  Bound: HBM bytes, one read of hi and lo
// and one write of lo (0.48 ms at 2^27 pairs).  k3_fix_runs gives each
// warp a window of 512 consecutive pairs in registers, 16 a lane loaded
// with 16-byte vectors, and writes the inner 440 (the tile): a pass moves
// information one position, so with a halo of 36 >= passes + 1 on each
// side the tile and the first pair past it are exact.  The block edges
// are a mask on the pairs, not a clip of the window.  The equal-hi mask
// is computed once; an even pass is register compare-exchanges only, an
// odd pass adds one shuffle each way for the pair across two lanes; no
// block barrier.  A warp whose window has no equal neighbours skips the
// passes (one vote), and a warp stops once two passes in a row swap
// nothing (a fixed point of both parities: the rest are no-ops).
//
// With a flag byte, the same entry is the pair engine's whole phase B:
// k3_fix_strips then finishes the runs that cross block edges in place,
// one warp a strip of 2*passes pairs around each of the nblk - 1 edges
// (two a lane, 2*passes odd-even passes of shuffles: the strips of
// ops/bitonic.py fix_boundary_plain), and both kernels set the flag byte when
// a pair of the final planes has equal hi and descending lo.  K3 judges
// the pairs no strip touches, the strip kernel the 2*passes + 1 pairs of
// its strip (its outer neighbours need bsz > 2*passes: nothing else
// writes them).
//
// Every entry point launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() or the first refused attribute (0 on
// success).  Keys compare as uint32 (int32 carriers hold unsigned bits).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kPairTileLog2 = 13;   // K2 tile: two planes, 64 KiB
constexpr int kPairRegs = 16;       // K2 pairs a thread holds (2^4)
constexpr int kKeyTileLog2 = 14;    // K1 tile: one plane, 72 KiB with pads
constexpr int kKeyRegs = 32;        // K1 keys a thread holds (2^5)
constexpr bool kPairBlocked = false;  // K2 threads hold pairs 32 apart
constexpr bool kKeyBlocked = true;    // K1 threads hold consecutive keys
constexpr int kStageLayers = 8;     // K2 layers a staged pass retires, at most
constexpr int kStagePairsLog2 = 14; // K2 staged block: 2^14 pairs, 128 KiB
constexpr int kStageThreads = 512;
constexpr int kTileRound = 4;       // layers a shared-memory round retires
constexpr int kMergeWinLog2 = 13;   // K1 merge window: 8192 keys
constexpr int kMergeThreads = 512;
constexpr int kMergeSpan = (1 << kMergeWinLog2) / kMergeThreads;  // 16
constexpr int kFixMaxPasses = 32;   // K3 passes, at most
constexpr int kFixRegs = 16;        // K3 consecutive pairs a lane holds
constexpr int kFixHalo = 36;        // K3 window pairs each side of the tile
constexpr int kFixWarps = 8;        // K3 warps a block (one window each)
constexpr int kFixWindow = 32 * kFixRegs;
constexpr int kFixTile = kFixWindow - 2 * kFixHalo;  // 440 pairs written a warp
static_assert(kTileRound == 4, "smem_layers dispatches rounds of 1..4 layers");
static_assert(kMergeSpan == 16, "k1_merge_round's padded stores assume 16");
static_assert(kFixHalo >= kFixMaxPasses + 1, "the pair past the tile must be exact");
static_assert(kFixHalo % 4 == 0 && kFixRegs % 4 == 0, "K3 moves 16-byte quads");

__host__ __device__ constexpr int ilog2(int v) { return v <= 1 ? 0 : 1 + ilog2(v / 2); }

// ------------------------------------------------------------ primitives

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(s)),
               "l"(g)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(s)),
               "l"(g)
               : "memory");
}

// Commit this thread's copies and wait for all of them; other threads see
// the data only after a __syncwarp / __syncthreads.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// One comparator: swap exactly when the keys are in the wrong order; the
// payload moves with its key, so a position keeps its payload iff its key
// is unchanged (ties keep their own).
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

// The same comparator across lanes lane and lane ^ d: each side keeps the
// min or the max and takes the partner's payload iff its key changed.
template <bool kPair>
__device__ __forceinline__ void shfl_exchange(uint32_t& k, uint32_t& p, int d,
                                              bool upper, bool asc) {
  const uint32_t ok = __shfl_xor_sync(0xffffffffu, k, d);
  const uint32_t op = kPair ? __shfl_xor_sync(0xffffffffu, p, d) : 0u;
  const uint32_t nk = (upper != asc) ? min(k, ok) : max(k, ok);
  if (kPair && nk != k) p = op;
  k = nk;
}

// Layers top..0 (top < 5 + log2 E) of stage m on the E elements a thread
// holds.  kBlocked: element r is index g0 | r (E consecutive elements;
// index bits log2 E .. log2 E + 4 are the lane); else element r is index
// g0 + 32 r (the lane is index bits 0..4, r the bits above).  Layers on
// lane bits are warp shuffles, the others register exchanges.
// Direction of element r's comparators at stage m.  kUniform (m >= 5 +
// log2 E: the warp's 32 E elements share bit m) computes it once.
template <int E, bool kBlocked, bool kUniform>
__device__ __forceinline__ bool ascending(uint32_t g0, int r, int m) {
  const uint32_t i = kUniform ? g0 : kBlocked ? (g0 | r) : g0 + 32u * r;
  return ((i >> m) & 1u) == 0;
}

template <bool kPair, int E, bool kBlocked, bool kUniform>
__device__ __forceinline__ void lane_layers(uint32_t (&kk)[E], uint32_t (&pp)[E],
                                            uint32_t g0, int m, int top) {
  constexpr int kLaneBit = kBlocked ? ilog2(E) : 0;  // lowest index bit of the lane
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 4; b >= 0; --b) {
    if (kLaneBit + b > top) continue;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      shfl_exchange<kPair>(kk[r], pp[r], 1 << b, (lane >> b) & 1,
                           ascending<E, kBlocked, kUniform>(g0, r, m));
    }
  }
}

template <bool kPair, int E, bool kBlocked, bool kUniform>
__device__ __forceinline__ void reg_layers(uint32_t (&kk)[E], uint32_t (&pp)[E],
                                           uint32_t g0, int m, int top) {
  constexpr int kRegBit = kBlocked ? 0 : 5;  // lowest index bit of r
#pragma unroll
  for (int b = ilog2(E) - 1; b >= 0; --b) {
    if (kRegBit + b > top) continue;
#pragma unroll
    for (int r = 0; r < E; ++r) {
      if (r & (1 << b)) continue;
      exchange<kPair>(kk[r], kk[r | (1 << b)], pp[r], pp[r | (1 << b)],
                      ascending<E, kBlocked, kUniform>(g0, r, m));
    }
  }
}

template <bool kPair, int E, bool kBlocked, bool kUniform>
__device__ __forceinline__ void warp_layers(uint32_t (&kk)[E], uint32_t (&pp)[E],
                                            uint32_t g0, int m, int top) {
  // layers in descending index bit order
  if constexpr (kBlocked) {
    lane_layers<kPair, E, kBlocked, kUniform>(kk, pp, g0, m, top);
    reg_layers<kPair, E, kBlocked, kUniform>(kk, pp, g0, m, top);
  } else {
    reg_layers<kPair, E, kBlocked, kUniform>(kk, pp, g0, m, top);
    lane_layers<kPair, E, kBlocked, kUniform>(kk, pp, g0, m, top);
  }
}

// Shared-memory slot of tile element e: with kPad, four pad words per 32
// put the 16-byte vectors of a thread's E consecutive elements on distinct
// banks (lane rows start 4 banks apart) and keep every chunk of four
// aligned.  Accesses of 32 consecutive elements a warp need no pad.
template <bool kPad>
__device__ __forceinline__ unsigned slot(unsigned e) {
  return kPad ? e + ((e >> 5) << 2) : e;
}

// Layers j .. j-R+1 (j-R+1 >= 5) over `elems` shared-memory elements: each
// group of 2^R elements (index bits j-R+1..j varying) runs through the R
// layers in registers.  A warp's 32 groups are 32 consecutive elements,
// so the round is free of bank conflicts.  dir(e) gives the direction of
// the comparators of element e.  A barrier ends the round.
template <bool kPair, bool kPad, int R, class Dir>
__device__ __forceinline__ void smem_round(uint32_t* sk, uint32_t* sp,
                                           unsigned elems, int j, Dir dir) {
  constexpr int E = 1 << R;
  const int low = j - R + 1;
  const unsigned stride = 1u << low;
  for (unsigned g = threadIdx.x; g < (elems >> R); g += blockDim.x) {
    const unsigned base = ((g >> low) << (j + 1)) | (g & (stride - 1));
    const bool asc = dir(base);
    uint32_t kk[E];
    uint32_t pp[E];
#pragma unroll
    for (int r = 0; r < E; ++r) {
      kk[r] = sk[slot<kPad>(base + r * stride)];
      pp[r] = kPair ? sp[slot<kPad>(base + r * stride)] : 0u;
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
      sk[slot<kPad>(base + r * stride)] = kk[r];
      if (kPair) sp[slot<kPad>(base + r * stride)] = pp[r];
    }
  }
  __syncthreads();
}

// Layers top .. bottom (bottom >= 5) in rounds of at most kTileRound.
template <bool kPair, bool kPad, class Dir>
__device__ __forceinline__ void smem_layers(uint32_t* sk, uint32_t* sp,
                                            unsigned elems, int top, int bottom,
                                            Dir dir) {
  for (int j = top; j >= bottom;) {
    const int r = j - bottom + 1 < kTileRound ? j - bottom + 1 : kTileRound;
    switch (r) {
      case 1: smem_round<kPair, kPad, 1>(sk, sp, elems, j, dir); break;
      case 2: smem_round<kPair, kPad, 2>(sk, sp, elems, j, dir); break;
      case 3: smem_round<kPair, kPad, 3>(sk, sp, elems, j, dir); break;
      default: smem_round<kPair, kPad, kTileRound>(sk, sp, elems, j, dir); break;
    }
    j -= r;
  }
}

// --------------------------------------------------------------- tile pass

// Shared memory of a tile of 2^tl elements and `planes` planes (see slot).
constexpr size_t tile_smem(int tl, int planes, bool pad) {
  return static_cast<size_t>(planes) * ((1u << tl) + (pad ? (1u << tl) >> 3 : 0u)) *
         sizeof(uint32_t);
}

// One tile of 2^tl elements (2^tl / E threads, tl >= 5 + log2 E) in
// shared memory.  kSort: stages 1..tl (the tile sort, reading kin, of
// which the first `valid` elements are real and the rest pads of
// 0xFFFFFFFF); else the in-tile tail (layers tl-1..0) of stage m, in place.
// Directions follow the global index, as the network has them (tiles
// alternate ascending and descending), or with kAscending the index inside
// the tile, so every tile ends ascending (K1's runs for the merge rounds).
// Each warp copies its own 32 E elements in with cp.async; the tile sort
// starts on them without a block barrier, and its first log2(32 E) stages
// never leave the warp.  A thread holds E elements, consecutive
// (kBlocked: its low stages need fewer shuffles, and it stores through
// shared memory) or 32 apart (stored straight from registers).
template <bool kPair, int E, bool kSort, bool kVec, bool kBlocked,
          bool kAscending = false>
__device__ __forceinline__ void tile_pass(const uint32_t* kin, const uint32_t* pin,
                                          uint32_t* kout, uint32_t* pout, int tl,
                                          unsigned valid, int m) {
  constexpr int WB = 5 + ilog2(E);  // index bits a warp holds
  constexpr unsigned SEG = 32u * E;
  extern __shared__ __align__(16) uint32_t smem[];
  const unsigned tile = 1u << tl;
  uint32_t* sk = smem;
  uint32_t* sp = smem + slot<kBlocked>(tile);
  const unsigned lane = threadIdx.x & 31;
  const unsigned seg = (threadIdx.x >> 5) * SEG;
  const unsigned mine = seg + (kBlocked ? lane * E : lane);  // element 0 of this thread
  const size_t gbase = static_cast<size_t>(blockIdx.x) << tl;
  const uint32_t gb = kAscending ? 0u : static_cast<uint32_t>(gbase);
  const uint32_t g0 = gb + mine;
  if (valid < tile) {  // a lone padded tile (n < 32 E)
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const unsigned e = seg + 32u * u + lane;
      sk[slot<kBlocked>(e)] = e < valid ? kin[e] : 0xFFFFFFFFu;
      if (kPair) sp[slot<kBlocked>(e)] = e < valid ? pin[e] : 0u;
    }
  } else if (kVec) {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const unsigned e = seg + 4u * (lane + 32u * q);
      cp_async16(sk + slot<kBlocked>(e), kin + gbase + e);
      if (kPair) cp_async16(sp + slot<kBlocked>(e), pin + gbase + e);
    }
  } else {
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const unsigned e = seg + 32u * u + lane;
      cp_async4(sk + slot<kBlocked>(e), kin + gbase + e);
      if (kPair) cp_async4(sp + slot<kBlocked>(e), pin + gbase + e);
    }
  }
  cp_async_wait_all();
  if (kSort) __syncwarp(); else __syncthreads();

  uint32_t kk[E];
  uint32_t pp[E];
  auto to_regs = [&] {
    if (kBlocked) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        const uint4 v = *reinterpret_cast<const uint4*>(sk + slot<kBlocked>(mine + 4 * q));
        kk[4 * q] = v.x; kk[4 * q + 1] = v.y; kk[4 * q + 2] = v.z; kk[4 * q + 3] = v.w;
        if (kPair) {
          const uint4 w = *reinterpret_cast<const uint4*>(sp + slot<kBlocked>(mine + 4 * q));
          pp[4 * q] = w.x; pp[4 * q + 1] = w.y; pp[4 * q + 2] = w.z; pp[4 * q + 3] = w.w;
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        kk[r] = sk[slot<kBlocked>(mine + 32u * r)];
        if (kPair) pp[r] = sp[slot<kBlocked>(mine + 32u * r)];
      }
    }
    if (!kPair) {
#pragma unroll
      for (int r = 0; r < E; ++r) pp[r] = 0u;
    }
  };
  auto to_smem = [&] {
    if (kBlocked) {
#pragma unroll
      for (int q = 0; q < E / 4; ++q) {
        *reinterpret_cast<uint4*>(sk + slot<kBlocked>(mine + 4 * q)) =
            make_uint4(kk[4 * q], kk[4 * q + 1], kk[4 * q + 2], kk[4 * q + 3]);
        if (kPair) {
          *reinterpret_cast<uint4*>(sp + slot<kBlocked>(mine + 4 * q)) =
              make_uint4(pp[4 * q], pp[4 * q + 1], pp[4 * q + 2], pp[4 * q + 3]);
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < E; ++r) {
        sk[slot<kBlocked>(mine + 32u * r)] = kk[r];
        if (kPair) sp[slot<kBlocked>(mine + 32u * r)] = pp[r];
      }
    }
  };
  if (kSort) {
    to_regs();
#pragma unroll
    for (int s = 1; s <= WB; ++s) warp_layers<kPair, E, kBlocked, false>(kk, pp, g0, s, s - 1);
    for (int s = WB + 1; s <= tl; ++s) {
      to_smem();
      __syncthreads();
      smem_layers<kPair, kBlocked>(sk, sp, tile, s - 1, WB, [=](unsigned e) {
        return (((gb + e) >> s) & 1u) == 0;
      });
      to_regs();
      warp_layers<kPair, E, kBlocked, true>(kk, pp, g0, s, WB - 1);
    }
  } else {
    // m > tl: one direction for the whole tile
    const bool asc = ((gbase >> m) & 1) == 0;
    smem_layers<kPair, kBlocked>(sk, sp, tile, tl - 1, WB, [=](unsigned) { return asc; });
    to_regs();
    warp_layers<kPair, E, kBlocked, true>(kk, pp, g0, m, WB - 1);
  }
  if (!kBlocked) {  // lanes hold consecutive elements: coalesced as they are
#pragma unroll
    for (int r = 0; r < E; ++r) {
      const unsigned e = mine + 32u * r;
      if (e < valid) {
        kout[gbase + e] = kk[r];
        if (kPair) pout[gbase + e] = pp[r];
      }
    }
    return;
  }
  // out through the warp's own segment: coalesced 16-byte stores
  to_smem();
  __syncwarp();
  if (valid < tile) {
#pragma unroll
    for (int u = 0; u < E; ++u) {
      const unsigned e = seg + 32u * u + lane;
      if (e < valid) {
        kout[e] = sk[slot<kBlocked>(e)];
        if (kPair) pout[e] = sp[slot<kBlocked>(e)];
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < E / 4; ++q) {
      const unsigned e = seg + 4u * (lane + 32u * q);
      *reinterpret_cast<uint4*>(kout + gbase + e) =
          *reinterpret_cast<const uint4*>(sk + slot<kBlocked>(e));
      if (kPair) {
        *reinterpret_cast<uint4*>(pout + gbase + e) =
            *reinterpret_cast<const uint4*>(sp + slot<kBlocked>(e));
      }
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__((1 << kPairTileLog2) / kPairRegs, 2)
k2_tile_sort(const uint32_t* kin, const uint32_t* pin, uint32_t* kout,
             uint32_t* pout, int tl, unsigned valid) {
  tile_pass<true, kPairRegs, true, kVec, kPairBlocked>(kin, pin, kout, pout, tl, valid, 0);
}

__global__ void __launch_bounds__((1 << kPairTileLog2) / kPairRegs, 2)
k2_tail_pass(uint32_t* k, uint32_t* p, int tl, int m) {
  tile_pass<true, kPairRegs, false, true, kPairBlocked>(k, p, k, p, tl, 1u << tl, m);
}

template <bool kVec>
__global__ void __launch_bounds__((1 << kKeyTileLog2) / kKeyRegs, 2)
k1_tile_sort(const uint32_t* in, uint32_t* out, int tl, unsigned valid) {
  tile_pass<false, kKeyRegs, true, kVec, kKeyBlocked, true>(in, nullptr, out, nullptr, tl,
                                                            valid, 0);
}

// ------------------------------------------------------- K2 staged passes

// Layers j .. j-R+1 of stage m over 2^R rows of 2^CL consecutive pairs
// (R + CL = kStagePairsLog2): row r starts at base + r 2^(j-R+1), where
// the block index supplies the bits CL .. j-R and the bits above j.  Every
// element of the block shares bit m (m > j), so one direction serves all.
// Fewer layers buy longer rows, and HBM streams long rows faster.
__global__ void __launch_bounds__(kStageThreads, 1)
k2_staged_pass(uint32_t* k, uint32_t* p, int j, int R, int CL, int m) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int low = j - R + 1;
  const unsigned elems = 1u << (R + CL);
  const unsigned quads = 1u << (CL - 2);  // 16-byte chunks a row
  uint32_t* sk = smem;
  uint32_t* sp = smem + elems;
  const size_t b = blockIdx.x;
  const size_t base = ((b >> (low - CL)) << (j + 1)) |
                      ((b & ((static_cast<size_t>(1) << (low - CL)) - 1)) << CL);
  for (unsigned q = threadIdx.x; q < elems / 4; q += blockDim.x) {
    const unsigned r = q >> (CL - 2), c = (q & (quads - 1)) * 4u;
    const size_t g = base + (static_cast<size_t>(r) << low) + c;
    cp_async16(sk + (r << CL) + c, k + g);
    cp_async16(sp + (r << CL) + c, p + g);
  }
  cp_async_wait_all();
  __syncthreads();
  // row bit x of the block is smem bit CL + x and global bit low + x
  const bool asc = ((base >> m) & 1) == 0;
  smem_layers<true, false>(sk, sp, elems, R - 1 + CL, CL, [=](unsigned) { return asc; });
  for (unsigned q = threadIdx.x; q < elems / 4; q += blockDim.x) {
    const unsigned r = q >> (CL - 2), c = (q & (quads - 1)) * 4u;
    const size_t g = base + (static_cast<size_t>(r) << low) + c;
    *reinterpret_cast<uint4*>(k + g) = *reinterpret_cast<const uint4*>(sk + (r << CL) + c);
    *reinterpret_cast<uint4*>(p + g) = *reinterpret_cast<const uint4*>(sp + (r << CL) + c);
  }
}

// ------------------------------------------------------- K1 merge rounds

// Merge-path start of every output window of one round: window q starts
// at diagonal d of its pair of runs (A then B, 2^run_log2 each); part[q]
// is how many of the window's predecessors come from A.  A is taken when
// a <= b, here and in k1_merge_round.
__global__ void k1_merge_partition(const uint32_t* __restrict__ src,
                                   uint32_t* __restrict__ part, size_t windows,
                                   int run_log2) {
  const size_t q = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= windows) return;
  const size_t L = static_cast<size_t>(1) << run_log2;
  const size_t o = q << kMergeWinLog2;
  const size_t pair0 = o & ~(2 * L - 1);
  const size_t d = o - pair0;
  const uint32_t* A = src + pair0;
  const uint32_t* B = A + L;
  size_t lo = d > L ? d - L : 0, hi = d < L ? d : L;
  while (lo < hi) {
    const size_t mid = (lo + hi) >> 1;
    if (A[mid] <= B[d - mid - 1]) lo = mid + 1; else hi = mid;
  }
  part[q] = static_cast<uint32_t>(lo);
}

__device__ __forceinline__ unsigned padded(unsigned e) { return e + (e >> 5); }

__global__ void __launch_bounds__(kMergeThreads, 3)
k1_merge_round(const uint32_t* __restrict__ src, const uint32_t* __restrict__ part,
               uint32_t* __restrict__ dst, int run_log2) {
  constexpr unsigned W = 1u << kMergeWinLog2;
  __shared__ __align__(16) uint32_t s[W + W / 32 + 16];
  const size_t L = static_cast<size_t>(1) << run_log2;
  const size_t o = static_cast<size_t>(blockIdx.x) << kMergeWinLog2;
  const size_t pair0 = o & ~(2 * L - 1);
  const size_t d = o - pair0;
  const uint32_t* A = src + pair0;
  const uint32_t* B = A + L;
  const size_t i0 = part[blockIdx.x];
  const size_t i1 = d + W == 2 * L ? L : part[blockIdx.x + 1];
  const size_t j0 = d - i0, j1 = d + W - i1;
  // both spans widened to 16-byte boundaries (runs start aligned, and a
  // run's length is a multiple of 4, so the widening stays in the run)
  const size_t a_lo = i0 & ~static_cast<size_t>(3), b_lo = j0 & ~static_cast<size_t>(3);
  const unsigned a_words = static_cast<unsigned>(((i1 + 3) & ~static_cast<size_t>(3)) - a_lo);
  const unsigned b_words = static_cast<unsigned>(((j1 + 3) & ~static_cast<size_t>(3)) - b_lo);
  for (unsigned q = threadIdx.x; q < (a_words + b_words) / 4; q += blockDim.x) {
    const unsigned e = 4u * q;
    cp_async16(s + e, e < a_words ? A + a_lo + e : B + b_lo + (e - a_words));
  }
  cp_async_wait_all();
  __syncthreads();
  const uint32_t* sa = s + (i0 & 3);
  const uint32_t* sb = s + a_words + (j0 & 3);
  const int na = static_cast<int>(i1 - i0), nb = static_cast<int>(j1 - j0);
  const int dt = static_cast<int>(threadIdx.x) * kMergeSpan;
  int lo = dt > nb ? dt - nb : 0, hi = dt < na ? dt : na;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (sa[mid] <= sb[dt - mid - 1]) lo = mid + 1; else hi = mid;
  }
  int i = lo, jb = dt - lo;
  uint32_t v[kMergeSpan];
#pragma unroll
  for (int u = 0; u < kMergeSpan; ++u) {
    const uint32_t a = i < na ? sa[i] : 0u;
    const uint32_t bv = jb < nb ? sb[jb] : 0u;
    const bool take_a = i < na && (jb >= nb || a <= bv);
    v[u] = take_a ? a : bv;
    i += take_a;
    jb += !take_a;
  }
  __syncthreads();
  // one pad word per 32 keeps the 16-apart spans of a warp off one bank
#pragma unroll
  for (int u = 0; u < kMergeSpan; ++u) s[padded(dt + u)] = v[u];
  __syncthreads();
  for (unsigned q = threadIdx.x; q < W / 4; q += blockDim.x) {
    const unsigned e = 4u * q;  // e .. e+3 share one 32-word group
    const unsigned f = padded(e);
    *reinterpret_cast<uint4*>(dst + o + e) = make_uint4(s[f], s[f + 1], s[f + 2], s[f + 3]);
  }
}

// -------------------------------------------------------------- host side

int log2_exact(long long n) {
  if (n <= 0 || (n & (n - 1)) != 0) return -1;
  int t = 0;
  while ((1LL << t) < n) ++t;
  return t;
}

bool aligned16(const void* a) { return (reinterpret_cast<uintptr_t>(a) & 15) == 0; }

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

#define RETURN_IF(err)                                     \
  do {                                                     \
    const cudaError_t e_ = (err);                          \
    if (e_ != cudaSuccess) return static_cast<int>(e_);    \
  } while (0)

// The tile of an n-element sort: the kernel's tile, or n itself, but at
// least one warp's worth (a smaller n is padded in shared memory).
int tile_log2(int t, int tile_max, int warp_bits) {
  const int tl = t < tile_max ? t : tile_max;
  return tl < warp_bits ? warp_bits : tl;
}

int run_pairs(const uint32_t* kin, const uint32_t* pin, uint32_t* k, uint32_t* p,
              long long n, cudaStream_t s) {
  constexpr int WB = 5 + ilog2(kPairRegs);
  const int t = log2_exact(n);
  if (t < 0 || t > 31 || !aligned16(k) || !aligned16(p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tl = tile_log2(t, kPairTileLog2, WB);
  const size_t tile = static_cast<size_t>(1) << tl;
  const unsigned valid = static_cast<unsigned>(n < static_cast<long long>(tile) ? n : tile);
  const size_t smem = tile_smem(tl, 2, kPairBlocked);
  const unsigned threads = static_cast<unsigned>(tile / kPairRegs);
  const unsigned tiles = static_cast<unsigned>(n >= static_cast<long long>(tile) ? n >> tl : 1);
  const size_t stage_smem = static_cast<size_t>(2) << (kStagePairsLog2 + 2);
  RETURN_IF(allow_smem(k2_tile_sort<true>, smem));
  RETURN_IF(allow_smem(k2_tile_sort<false>, smem));
  RETURN_IF(allow_smem(k2_tail_pass, smem));
  RETURN_IF(allow_smem(k2_staged_pass, stage_smem));
  if (aligned16(kin) && aligned16(pin)) {
    k2_tile_sort<true><<<tiles, threads, smem, s>>>(kin, pin, k, p, tl, valid);
  } else {
    k2_tile_sort<false><<<tiles, threads, smem, s>>>(kin, pin, k, p, tl, valid);
  }
  for (int m = tl + 1; m <= t; ++m) {
    // the stage's layers above the tile, in as few passes as kStageLayers
    // allows, split evenly so that every pass keeps rows long
    int left = m - tl;
    const int passes = (left + kStageLayers - 1) / kStageLayers;
    for (int i = 0, j = m - 1; i < passes; ++i) {
      const int r = (left + passes - i - 1) / (passes - i);
      k2_staged_pass<<<static_cast<unsigned>(n >> kStagePairsLog2), kStageThreads,
                       stage_smem, s>>>(k, p, j, r, kStagePairsLog2 - r, m);
      j -= r;
      left -= r;
    }
    k2_tail_pass<<<tiles, threads, smem, s>>>(k, p, tl, m);
  }
  return static_cast<int>(cudaGetLastError());
}

int run_keys(const uint32_t* in, uint32_t* out, uint32_t* scratch,
             long long scratch_words, long long n, cudaStream_t s) {
  constexpr int WB = 5 + ilog2(kKeyRegs);
  const int t = log2_exact(n);
  if (t < 0 || t > 31 || !aligned16(out)) return static_cast<int>(cudaErrorInvalidValue);
  const int tl = tile_log2(t, kKeyTileLog2, WB);
  const int rounds = t > tl ? t - tl : 0;
  const size_t windows = rounds ? static_cast<size_t>(n) >> kMergeWinLog2 : 0;
  if (rounds && (scratch == nullptr || !aligned16(scratch) ||
                 scratch_words < n + static_cast<long long>(windows))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t tile = static_cast<size_t>(1) << tl;
  const unsigned valid = static_cast<unsigned>(n < static_cast<long long>(tile) ? n : tile);
  const size_t smem = tile_smem(tl, 1, kKeyBlocked);
  const unsigned threads = static_cast<unsigned>(tile / kKeyRegs);
  const unsigned tiles = static_cast<unsigned>(n >= static_cast<long long>(tile) ? n >> tl : 1);
  RETURN_IF(allow_smem(k1_tile_sort<true>, smem));
  RETURN_IF(allow_smem(k1_tile_sort<false>, smem));
  // ping-pong so that the last round writes `out`
  uint32_t* buf[2] = {out, scratch};
  int cur = rounds & 1;
  if (aligned16(in)) {
    k1_tile_sort<true><<<tiles, threads, smem, s>>>(in, buf[cur], tl, valid);
  } else {
    k1_tile_sort<false><<<tiles, threads, smem, s>>>(in, buf[cur], tl, valid);
  }
  uint32_t* part = scratch + n;
  for (int r = 0; r < rounds; ++r) {
    const int run_log2 = tl + r;
    k1_merge_partition<<<static_cast<unsigned>((windows + 255) / 256), 256, 0, s>>>(
        buf[cur], part, windows, run_log2);
    k1_merge_round<<<static_cast<unsigned>(windows), kMergeThreads, 0, s>>>(
        buf[cur], part, buf[cur ^ 1], run_log2);
    cur ^= 1;
  }
  return static_cast<int>(cudaGetLastError());
}

constexpr unsigned kFull = 0xFFFFFFFFu;

// One compare-exchange of K3: lo[j], lo[j+1] swapped when the pair is
// inside one equal-hi run (bit j of `eq`) and descending.
template <int E>
__device__ __forceinline__ bool fix_cx(uint32_t (&v)[E], uint32_t eq, int j) {
  const uint32_t a = v[j], b = v[j + 1];
  const bool s = ((eq >> j) & 1u) && a > b;
  v[j] = s ? b : a;
  v[j + 1] = s ? a : b;
  return s;
}

// grid: one warp a tile of kFixTile pairs, kFixWarps warps a block.  The
// warp's window starts kFixHalo pairs before its tile (an even index, so
// the lane's pair j has the parity of j).  strip_w > 0: the strips of
// half-width strip_w are k3_fix_strips's, and flag != null collects the
// residual of every other pair.
__global__ void __launch_bounds__(kFixWarps * 32)
k3_fix_runs(const uint32_t* __restrict__ hi, const uint32_t* __restrict__ lo,
            uint32_t* __restrict__ out, unsigned char* __restrict__ flag,
            long long n, int passes, int bsz_log2, int strip_w, bool vec) {
  constexpr int E = kFixRegs;
  const int lane = threadIdx.x & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * kFixWarps + (threadIdx.x >> 5);
  const long long c0 = tile * kFixTile;
  if (c0 >= n) return;                                  // the whole warp
  const long long e0 = c0 - kFixHalo + static_cast<long long>(lane) * E;
  const long long bmask = (1LL << bsz_log2) - 1;
  uint32_t h[E], v[E];
  uint32_t valid = 0;
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const long long i = e0 + 4 * q;
    if (vec && i >= 0 && i + 4 <= n) {
      const uint4 a = *reinterpret_cast<const uint4*>(hi + i);
      const uint4 b = *reinterpret_cast<const uint4*>(lo + i);
      h[4 * q] = a.x; h[4 * q + 1] = a.y; h[4 * q + 2] = a.z; h[4 * q + 3] = a.w;
      v[4 * q] = b.x; v[4 * q + 1] = b.y; v[4 * q + 2] = b.z; v[4 * q + 3] = b.w;
      valid |= 0xFu << (4 * q);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const bool in = i + r >= 0 && i + r < n;
        h[4 * q + r] = in ? hi[i + r] : 0u;
        v[4 * q + r] = in ? lo[i + r] : 0u;
        valid |= static_cast<uint32_t>(in) << (4 * q + r);
      }
    }
  }
  // eqr bit j: pair (j, j+1) has equal hi (j = E-1: the next lane's first
  // pair; never past the window); eq: the same inside one bsz block
  const uint32_t h_next = __shfl_down_sync(kFull, h[0], 1);
  const uint32_t valid_next = __shfl_down_sync(kFull, valid, 1) & 1u;
  // judge: the pairs of the tile whose residual this kernel decides (equal
  // hi, no strip touches them), a data-independent mask set once.  Pair i
  // is in the strip of edge k = u / bsz, u = i + strip_w + 1, when u mod
  // bsz <= 2 * strip_w and 1 <= k < nblk, i.e. bsz <= u < n; 32-bit
  // offsets suffice (n <= 2^31)
  const uint32_t bm32 = static_cast<uint32_t>(bmask);
  const uint32_t i32 = static_cast<uint32_t>(e0);
  const uint32_t u32 = i32 + static_cast<uint32_t>(strip_w) + 1u;
  const uint32_t bsz32 = bm32 + 1u, n32 = static_cast<uint32_t>(n - 1) + 1u;
  const long long core_lo = c0 - e0, core_hi = c0 + kFixTile - e0;  // lane-relative
  uint32_t eqr = 0, cut = 0, judge = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    const bool both = j + 1 < E ? ((valid >> j) & (valid >> (j + 1)) & 1u)
                                : (lane < 31 && ((valid >> j) & valid_next & 1u));
    const uint32_t right = j + 1 < E ? h[j + 1] : h_next;
    eqr |= static_cast<uint32_t>(both && h[j] == right) << j;
    cut |= static_cast<uint32_t>(((i32 + j + 1u) & bm32) == 0) << j;
    const uint32_t u = u32 + j;
    const bool strip = strip_w > 0 && (u & bm32) <= 2u * strip_w && u >= bsz32 && u < n32;
    judge |= static_cast<uint32_t>(j >= core_lo && j < core_hi && !strip) << j;
  }
  judge &= eqr;
  const uint32_t eq = eqr & ~cut;
  const uint32_t eq_prev = __shfl_up_sync(kFull, eq, 1);   // every lane takes part
  const bool eq_left = lane > 0 && ((eq_prev >> (E - 1)) & 1u);
  if (__any_sync(kFull, eq != 0)) {
    int quiet = 0;
    for (int t = 0; t < passes; ++t) {
      bool sw = false;
      if ((t & 1) == 0) {
#pragma unroll
        for (int j = 0; j < E; j += 2) sw |= fix_cx(v, eq, j);
      } else {
        const uint32_t from_next = __shfl_down_sync(kFull, v[0], 1);
        const uint32_t from_prev = __shfl_up_sync(kFull, v[E - 1], 1);
#pragma unroll
        for (int j = 1; j + 1 < E; j += 2) sw |= fix_cx(v, eq, j);
        if (((eq >> (E - 1)) & 1u) && v[E - 1] > from_next) {
          v[E - 1] = from_next;
          sw = true;
        }
        if (eq_left && from_prev > v[0]) {
          v[0] = from_prev;
          sw = true;
        }
      }
      if (__any_sync(kFull, sw)) {
        quiet = 0;
      } else if (++quiet == 2) {
        break;
      }
    }
  }
  // the tile's quads (the tile and the window start are multiples of 4)
#pragma unroll
  for (int q = 0; q < E / 4; ++q) {
    const long long i = e0 + 4 * q;
    if (i < c0 || i >= c0 + kFixTile || i >= n) continue;
    if (vec && i + 4 <= n) {
      *reinterpret_cast<uint4*>(out + i) =
          make_uint4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        if (i + r < n) out[i + r] = v[4 * q + r];
      }
    }
  }
  if (flag == nullptr) return;
  const uint32_t v_next = __shfl_down_sync(kFull, v[0], 1);
  uint32_t desc = 0;
#pragma unroll
  for (int j = 0; j < E; ++j) {
    desc |= static_cast<uint32_t>(v[j] > (j + 1 < E ? v[j + 1] : v_next)) << j;
  }
  // one store a warp that found a residual, and none once the byte is
  // set: every warp storing to one address would queue at L2
  if (__any_sync(kFull, (desc & judge) != 0) && lane == 0 &&
      *static_cast<volatile unsigned char*>(flag) == 0) {
    *flag = 1;
  }
}

// grid: one warp a block edge k = 1 .. nblk-1, kFixWarps warps a block.
// The strip is [k*bsz - w, k*bsz + w) of the `lo` plane K3 wrote; lane l
// < w holds its columns 2l and 2l+1 (column parity, as the strips of
// fix_boundary_plain compare them).  2w passes sort every equal-hi segment of
// the strip in place; then the 2w + 1 pairs from (start - 1, start) to
// (end - 1, end) are judged for the flag.
__global__ void __launch_bounds__(kFixWarps * 32)
k3_fix_strips(const uint32_t* __restrict__ hi, uint32_t* __restrict__ lo,
              unsigned char* __restrict__ flag, long long n, int w, int bsz_log2) {
  const int lane = threadIdx.x & 31;
  const long long k = 1 + static_cast<long long>(blockIdx.x) * kFixWarps + (threadIdx.x >> 5);
  if (k >= (n >> bsz_log2)) return;                     // the whole warp
  const long long s0 = (k << bsz_log2) - w;
  const long long a = s0 + 2 * lane;
  const bool act = lane < w;
  uint32_t h0 = 0, h1 = 0, v0 = 0, v1 = 0;
  if (act) {
    h0 = hi[a];
    h1 = hi[a + 1];
    v0 = lo[a];
    v1 = lo[a + 1];
  }
  const uint32_t h_next = __shfl_down_sync(kFull, h0, 1);
  const bool e_in = act && h0 == h1;
  const bool e_x = lane + 1 < w && h1 == h_next;        // (2l+1, 2l+2)
  const bool e_left = __shfl_up_sync(kFull, e_x, 1) != 0 && lane > 0;
  int quiet = 0;
  for (int t = 0; t < 2 * w; ++t) {
    bool sw = false;
    if ((t & 1) == 0) {
      if (e_in && v0 > v1) {
        const uint32_t x = v0;
        v0 = v1;
        v1 = x;
        sw = true;
      }
    } else {
      const uint32_t from_next = __shfl_down_sync(kFull, v0, 1);
      const uint32_t from_prev = __shfl_up_sync(kFull, v1, 1);
      if (e_x && v1 > from_next) {
        v1 = from_next;
        sw = true;
      }
      if (e_left && from_prev > v0) {
        v0 = from_prev;
        sw = true;
      }
    }
    if (__any_sync(kFull, sw)) {
      quiet = 0;
    } else if (++quiet == 2) {
      break;
    }
  }
  if (act) {
    lo[a] = v0;
    lo[a + 1] = v1;
  }
  const uint32_t v_next = __shfl_down_sync(kFull, v0, 1);
  bool bad = (e_in && v0 > v1) || (e_x && v1 > v_next);
  if (lane == 0) bad |= hi[s0 - 1] == h0 && lo[s0 - 1] > v0;
  if (lane == w - 1) bad |= hi[s0 + 2 * w] == h1 && v1 > lo[s0 + 2 * w];
  if (__any_sync(kFull, bad) && lane == 0 && *static_cast<volatile unsigned char*>(flag) == 0) {
    *flag = 1;
  }
}

}  // namespace

extern "C" {

// K1: sort n_pow2 uint32 keys ascending from `in` into `out` (`in` is
// never written).  `scratch` holds at least n_pow2 + n_pow2 / 8192 words
// when n_pow2 > 2^15 (the merge rounds' second plane and window starts);
// it may be null below.  `out` and `scratch` 16-byte aligned.
int bitonic_u32(const void* in, void* out, void* scratch, long long scratch_words,
                long long n_pow2, void* stream) {
  return run_keys(static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out),
                  static_cast<uint32_t*>(scratch), scratch_words, n_pow2,
                  static_cast<cudaStream_t>(stream));
}

// K2: sort (key, payload) pairs by key with the bitonic network; the
// payload follows its key.  `kout` and `pout` 16-byte aligned.
int bitonic_pairs_u32(const void* kin, const void* pin, void* kout,
                      void* pout, long long n_pow2, void* stream) {
  return run_pairs(static_cast<const uint32_t*>(kin),
                   static_cast<const uint32_t*>(pin),
                   static_cast<uint32_t*>(kout), static_cast<uint32_t*>(pout),
                   n_pow2, static_cast<cudaStream_t>(stream));
}

// K3: `passes` (<= 32) segment-masked odd-even passes of lo within runs of
// equal hi inside each bsz block; writes the new lo plane to `out` (not
// `lo`).  With `flag` (one device byte) non-null it is the pair engine's
// phase B: the runs across block edges are finished in `out` as well
// (the boundary strips; bsz > 2 * passes when there are two blocks or
// more) and *flag becomes 1 when some pair of the final planes has equal
// hi and descending lo (unsigned), else 0.
int fix_runs_pairs(const void* hi, const void* lo, void* out, void* flag, long long n,
                   int passes, long long bsz, void* stream) {
  const int bl = log2_exact(bsz);
  if (bl < 1 || log2_exact(n) < bl || log2_exact(n) > 31 || passes < 0 ||
      passes > kFixMaxPasses) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long nblk = n >> bl;
  const int strip_w = flag != nullptr && nblk >= 2 ? passes : 0;
  if (strip_w > 0 && bsz <= 2LL * strip_w) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* f = static_cast<unsigned char*>(flag);
  if (f != nullptr) RETURN_IF(cudaMemsetAsync(f, 0, 1, s));
  const long long tiles = (n + kFixTile - 1) / kFixTile;
  const bool vec = aligned16(hi) && aligned16(lo) && aligned16(out);
  k3_fix_runs<<<static_cast<unsigned>((tiles + kFixWarps - 1) / kFixWarps), kFixWarps * 32,
                0, s>>>(static_cast<const uint32_t*>(hi), static_cast<const uint32_t*>(lo),
                        static_cast<uint32_t*>(out), f, n, passes, bl, strip_w, vec);
  if (strip_w > 0) {
    k3_fix_strips<<<static_cast<unsigned>((nblk - 1 + kFixWarps - 1) / kFixWarps),
                    kFixWarps * 32, 0, s>>>(static_cast<const uint32_t*>(hi),
                                            static_cast<uint32_t*>(out), f, n, strip_w, bl);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
