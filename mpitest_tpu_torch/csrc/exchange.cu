// Exchange kernels of the distributed sorts for Hopper (sm_90a): the pack
// that spreads ragged per-destination segments into the [P, cap] send
// matrix, and the rank-to-rank transport of those matrices.
//
// Replaces the Pallas kernels behind parallel/collectives.py's
// ragged_all_to_all in the reference package:
//
//   K5 segment_pack    <- _pack_kernel (segment_pack, the pallas_call at
//                         mpitest_tpu/ops/pallas_kernels.py:139)
//   K6 fused_pass_pack <- _fused_pack_kernel (fused_pass_pack,
//                         mpitest_tpu/ops/exchange.py:159)
//   K7 remote_a2a      <- _remote_a2a_kernel (remote_a2a,
//                         mpitest_tpu/ops/exchange.py:244)
//
// and the receive side of the radix exchange, which replaces no Pallas
// kernel:
//
//   slot_place         <- the sorts keyed on the lane slot in
//                         mpitest_tpu/models/radix_sort.py (lax.sort on
//                         (digit, slot) merging a pass, on slot alone
//                         after the last one)
//
// K5/K6 compute, for every destination p and lane c < cap,
//
//   out[p, c] = c < cnt[p] ? data[start[p] + c] : fill
//
// (a lane inside its count whose source lies past n reads 0, as the
// reference's zero-padded input does).  The TPU geometry, (8, 128) tiles,
// a 2-chunk DMA window and a roll shift for the misaligned start, does not
// carry over: here each thread owns four consecutive lanes of one row,
// reads them with one 16-byte load where the source is aligned and fully
// inside the segment (four coalesced 4-byte loads otherwise), and writes
// them with one 16-byte store (rows start at multiples of cap, itself a
// multiple of 4, so stores are always aligned).  K6 computes the
// addressing once and moves every word plane (up to four) through it.
// Source addresses are clamped to [0, n): nothing reads out of bounds.
//
// K7 is the push form of the reference's remote-DMA all-to-all: one
// launch on rank `me`'s device copies its row dst of the send matrix into
// row `me` of rank dst's receive buffer, for every dst (the self block
// included), through a device array of P destination pointers.  The TPU
// kernel's ready barrier and DMA semaphores become stream order: the
// caller enqueues every rank's pack before any push and every push before
// any read of a receive buffer (one stream when all ranks share a card;
// events across cards, with peer access enabled per device pair by
// exchange_enable_peer_access).
//
// Across processes the destination pointers include other processes'
// receive buffers, mapped through CUDA IPC: each process allocates its
// ranks' receive arena with exchange_ipc_alloc (a cudaMalloc of its own,
// so that the IPC handle names exactly that allocation), publishes
// exchange_ipc_handle, and maps every peer's with exchange_ipc_open.  The
// ready barrier is then a stream synchronisation and a barrier of the
// processes on each side of the pushes (ops/exchange.py); the kernel is
// the same.
//
// slot_place writes every received lane of a [P, cap] receive matrix to
// the output slot the radix sort already computed for it
// (models/radix_sort.py _lane_slots): out[k][slot] = recv[k][lane] where
// slot < n as an unsigned number; lanes with the slot n are padding.
// The valid slots tile [0, n) once, so this is the permutation that the
// reference applies by sorting on the slot; on a TPU a scatter is slow,
// on this card it is one pass.  Optionally it also writes each placed
// lane's radix digit of one plane (`(word >> shift) & mask`, or
// `invalid` for a lane at or past its row's received count), so that the
// next pass sorts the digits of n lanes instead of P*cap.  Each thread
// reads four lanes of the slot plane with one 16-byte load (rows start at
// multiples of cap, a multiple of 4, so the loads are aligned); a quad
// with no valid slot reads no word plane, a warp with none skips the
// step, and the others read each plane with one 16-byte load.  The
// addressing serves every plane.  The writes are scalar and scattered by
// nature; inside one digit run of a sender row consecutive lanes carry
// consecutive slots, so each warp passes its 128 lanes through shared
// memory and writes them in lane order, one 128-byte line a store where
// a run allows.  Slots that no lane fills (an overflowed exchange) keep
// what the caller put in the output; the bounds check alone keeps the
// kernel in bounds.
//
// Bound on the H100: HBM bytes, all four.  K5/K6 read the n input words
// and write P*cap words per plane; K7 reads and writes P*cap words per
// rank; slot_place reads the P*cap slots and the valid lanes of each
// plane and writes n words per plane.  The kernels do no arithmetic worth
// counting beside their copies.
//
// Every kernel entry launches on the caller's stream, allocates nothing,
// and returns cudaGetLastError() (0 on success); a refused argument
// returns cudaErrorInvalidValue without launching.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxPlanes = 4;
constexpr int kThreads = 256;
constexpr int kVec = 4;                       // lanes per thread (16 bytes)
constexpr int kMaxA2aBlocks = 4096;           // grid-stride cap per row

struct PackPlanes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
  uint32_t fill[kMaxPlanes];
};

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// grid (ceil(cap / (kThreads * kVec)), P): thread t of block (bx, p) owns
// lanes [c0, c0 + 4) of row p.
__global__ void __launch_bounds__(kThreads)
pack_rows(PackPlanes pl, int n_planes, const int32_t* __restrict__ starts,
          const int32_t* __restrict__ cnts, long long n, int cap) {
  const int p = blockIdx.y;
  const long long c0 =
      (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x) * kVec;
  if (c0 >= cap) return;
  const long long start = starts[p];
  const long long cnt = cnts[p];
  const long long src = start + c0;
  const size_t o = static_cast<size_t>(p) * cap + c0;
  // the whole quad is data: inside the count and inside [0, n)
  const bool whole = c0 + kVec <= cnt && src >= 0 && src + kVec <= n;
#pragma unroll
  for (int q = 0; q < kMaxPlanes; ++q) {
    if (q >= n_planes) break;
    const uint32_t* in = pl.in[q];
    uint4 v;
    if (whole && aligned16(in + src)) {
      v = *reinterpret_cast<const uint4*>(in + src);
    } else {
      uint32_t e[kVec];
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const long long s = src + j;
        const bool data = s >= 0 && s < n;
        e[j] = c0 + j < cnt ? (data ? in[s] : 0u) : pl.fill[q];
      }
      v = make_uint4(e[0], e[1], e[2], e[3]);
    }
    *reinterpret_cast<uint4*>(pl.out[q] + o) = v;
  }
}

// grid (x, P): blocks of row dst copy send[dst, :] to dst_ptrs[dst] + me*cap.
__global__ void __launch_bounds__(kThreads)
a2a_push(const uint4* __restrict__ send, uint32_t* const* __restrict__ dst_ptrs,
         int me, int cap) {
  const int dst = blockIdx.y;
  const size_t quads = static_cast<size_t>(cap) / kVec;
  const uint4* in = send + static_cast<size_t>(dst) * quads;
  uint4* out = reinterpret_cast<uint4*>(dst_ptrs[dst] +
                                        static_cast<size_t>(me) * cap);
  for (size_t i = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < quads; i += static_cast<size_t>(gridDim.x) * kThreads) {
    out[i] = in[i];
  }
}

struct PlacePlanes {
  const uint32_t* in[kMaxPlanes];
  uint32_t* out[kMaxPlanes];
};

// The optional digit plane of slot_place: out[slot] is the digit of plane
// `plane` for a lane inside its row's count, `invalid` past it.
struct PlaceDigit {
  uint32_t* out;
  const int32_t* cnts;
  int plane;
  int shift;
  uint32_t mask;
  uint32_t invalid;
};

constexpr int kWarps = kThreads / 32;

// grid (x, P): the blocks of row s walk its quads with a grid stride, one
// quad a thread and 32 consecutive quads a warp.  A warp stages its 128
// lanes' slots and words in shared memory and writes them out in lane
// order, so that consecutive threads write consecutive slots within a
// digit run.
template <bool kDigit>
__global__ void __launch_bounds__(kThreads)
place_rows(PlacePlanes pl, int n_planes, const int32_t* __restrict__ slot,
           int cap, uint32_t n, PlaceDigit dg) {
  __shared__ uint4 s_slot[kWarps][32];
  __shared__ uint4 s_word[kMaxPlanes][kWarps][32];
  const int s = blockIdx.y;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const size_t row = static_cast<size_t>(s) * cap;
  const int quads = cap / kVec;
  const int cnt = kDigit ? dg.cnts[s] : 0;
  const uint32_t* staged_slot = reinterpret_cast<const uint32_t*>(s_slot[warp]);
  for (int base = blockIdx.x * kThreads + warp * 32; base < quads;
       base += gridDim.x * kThreads) {
    const int q = base + lane;
    const size_t at = row + static_cast<size_t>(q) * kVec;
    uint4 sv = make_uint4(n, n, n, n);
    if (q < quads) sv = *reinterpret_cast<const uint4*>(slot + at);
    const bool any = sv.x < n || sv.y < n || sv.z < n || sv.w < n;
    if (!__any_sync(0xFFFFFFFFu, any)) continue;   // the row's padding
    s_slot[warp][lane] = sv;
#pragma unroll
    for (int k = 0; k < kMaxPlanes; ++k) {
      if (k >= n_planes) break;
      if (any) s_word[k][warp][lane] = *reinterpret_cast<const uint4*>(pl.in[k] + at);
    }
    __syncwarp();
    // staged lane i is lane base * 4 + i of the row
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = j * 32 + lane;
      const uint32_t sl = staged_slot[i];
      if (sl >= n) continue;
#pragma unroll
      for (int k = 0; k < kMaxPlanes; ++k) {
        if (k >= n_planes) break;
        const uint32_t w = reinterpret_cast<const uint32_t*>(s_word[k][warp])[i];
        pl.out[k][sl] = w;
        if (kDigit && k == dg.plane) {
          dg.out[sl] = base * kVec + i < cnt ? (w >> dg.shift) & dg.mask : dg.invalid;
        }
      }
    }
    __syncwarp();   // the staging is the next step's
  }
}

bool host_aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

int launch_pack(const PackPlanes& pl, int n_planes, const void* starts,
                const void* cnts, long long n, int n_ranks, int cap,
                void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n < 0 || n_ranks < 1 ||
      n_ranks > 65535 || cap < kVec || cap % kVec != 0 ||
      static_cast<long long>(n_ranks) * cap >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int q = 0; q < n_planes; ++q) {
    if (!host_aligned16(pl.out[q])) return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long per_block = static_cast<long long>(kThreads) * kVec;
  const dim3 grid(static_cast<unsigned>((cap + per_block - 1) / per_block),
                  static_cast<unsigned>(n_ranks));
  pack_rows<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      pl, n_planes, static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(cnts), n, cap);
  return static_cast<int>(cudaGetLastError());
}

// Total blocks of one slot_place launch, spread over the rows: enough
// to keep every SM of the card busy through the grid-stride loop.
constexpr int kPlaceBlocks = 2048;

int launch_place(const PlacePlanes& pl, int n_planes, const void* slot,
                 long long n, int n_ranks, int cap, const PlaceDigit& dg,
                 void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n < 0 || n >= (1LL << 31) ||
      n_ranks < 1 || n_ranks > 65535 || cap < kVec || cap % kVec != 0 ||
      static_cast<long long>(n_ranks) * cap >= (1LL << 31) ||
      !host_aligned16(slot)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // with n = 0 nothing is written, and the empty outputs may be null
  for (int q = 0; q < n_planes; ++q) {
    if (!host_aligned16(pl.in[q]) || (pl.out[q] == nullptr && n > 0)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (dg.out != nullptr &&
      (dg.cnts == nullptr || dg.plane < 0 || dg.plane >= n_planes)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long quads = cap / kVec;
  long long blocks = (quads + kThreads - 1) / kThreads;
  const long long per_row = kPlaceBlocks / n_ranks > 0 ? kPlaceBlocks / n_ranks : 1;
  if (blocks > per_row) blocks = per_row;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_ranks));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* sl = static_cast<const int32_t*>(slot);
  const uint32_t nn = static_cast<uint32_t>(n);
  if (dg.out != nullptr) {
    place_rows<true><<<grid, kThreads, 0, st>>>(pl, n_planes, sl, cap, nn, dg);
  } else {
    place_rows<false><<<grid, kThreads, 0, st>>>(pl, n_planes, sl, cap, nn, dg);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// K5: spread one plane data[0, n) into out[n_ranks, cap]: row p holds
// data[starts[p] + c] for c < cnts[p], `fill` past it (int32 starts/cnts
// on the device).
int segment_pack(const void* data, void* out, const void* starts,
                 const void* cnts, long long n, int n_ranks, int cap,
                 unsigned fill, void* stream) {
  PackPlanes pl{};
  pl.in[0] = static_cast<const uint32_t*>(data);
  pl.out[0] = static_cast<uint32_t*>(out);
  pl.fill[0] = fill;
  return launch_pack(pl, 1, starts, cnts, n, n_ranks, cap, stream);
}

// K6: the same spread for n_planes (1..4) planes in one launch, one fill
// per plane; unused pointers may be null.
int fused_pass_pack(const void* in0, const void* in1, const void* in2,
                    const void* in3, void* out0, void* out1, void* out2,
                    void* out3, unsigned fill0, unsigned fill1, unsigned fill2,
                    unsigned fill3, int n_planes, const void* starts,
                    const void* cnts, long long n, int n_ranks, int cap,
                    void* stream) {
  PackPlanes pl{};
  const void* ins[kMaxPlanes] = {in0, in1, in2, in3};
  void* outs[kMaxPlanes] = {out0, out1, out2, out3};
  const unsigned fills[kMaxPlanes] = {fill0, fill1, fill2, fill3};
  for (int q = 0; q < kMaxPlanes; ++q) {
    pl.in[q] = static_cast<const uint32_t*>(ins[q]);
    pl.out[q] = static_cast<uint32_t*>(outs[q]);
    pl.fill[q] = fills[q];
  }
  return launch_pack(pl, n_planes, starts, cnts, n, n_ranks, cap, stream);
}

// K7: rank `me` pushes row dst of its send matrix [n_ranks, cap] into row
// `me` of the receive buffer dst_ptrs[dst] ([n_ranks, cap] on the device of
// rank dst), for every dst; dst_ptrs is a device array of n_ranks pointers.
int remote_a2a(const void* send, const void* dst_ptrs, int me, int n_ranks,
               int cap, void* stream) {
  if (n_ranks < 1 || n_ranks > 65535 || me < 0 || me >= n_ranks ||
      cap < kVec || cap % kVec != 0 ||
      static_cast<long long>(n_ranks) * cap >= (1LL << 31) ||
      !host_aligned16(send)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long quads = cap / kVec;
  long long blocks = (quads + kThreads - 1) / kThreads;
  if (blocks > kMaxA2aBlocks) blocks = kMaxA2aBlocks;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(n_ranks));
  a2a_push<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(send), static_cast<uint32_t* const*>(dst_ptrs),
      me, cap);
  return static_cast<int>(cudaGetLastError());
}

// Place the received lanes of n_planes (1..4) receive matrices
// [n_ranks, cap] by their int32 slot plane: out_k[slot[l]] = in_k[l] for
// every lane l with 0 <= slot[l] < n; nothing is written for the others.
// With digit_out non-null, also digit_out[slot[l]] = the digit_bits-wide
// digit at bit digit_shift of in_{digit_plane}[l] for a lane inside its
// row's count (cnts: int32[n_ranks] on the device), 1 << digit_bits past
// it.  The outputs hold n words each.
int slot_place(const void* in0, const void* in1, const void* in2,
               const void* in3, void* out0, void* out1, void* out2,
               void* out3, int n_planes, const void* slot, long long n,
               int n_ranks, int cap, void* digit_out, int digit_plane,
               int digit_shift, int digit_bits, const void* cnts,
               void* stream) {
  PlacePlanes pl{};
  const void* ins[kMaxPlanes] = {in0, in1, in2, in3};
  void* outs[kMaxPlanes] = {out0, out1, out2, out3};
  for (int q = 0; q < kMaxPlanes; ++q) {
    pl.in[q] = static_cast<const uint32_t*>(ins[q]);
    pl.out[q] = static_cast<uint32_t*>(outs[q]);
  }
  PlaceDigit dg{};
  if (digit_out != nullptr) {
    if (digit_shift < 0 || digit_shift > 31 || digit_bits < 1 || digit_bits > 30) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    // the bits that came from the word: at most 32 - shift (ops/kernels.py
    // digit_at)
    const int width = digit_bits < 32 - digit_shift ? digit_bits : 32 - digit_shift;
    dg.out = static_cast<uint32_t*>(digit_out);
    dg.cnts = static_cast<const int32_t*>(cnts);
    dg.plane = digit_plane;
    dg.shift = digit_shift;
    dg.mask = (1u << width) - 1u;
    dg.invalid = 1u << digit_bits;
  }
  return launch_place(pl, n_planes, slot, n, n_ranks, cap, dg, stream);
}

// Let `device` read and write the memory of `peer` (once per ordered pair;
// an already enabled pair is success).  Not a kernel launch.
int exchange_enable_peer_access(int device, int peer) {
  int prev = 0;
  cudaError_t e = cudaGetDevice(&prev);
  if (e != cudaSuccess) return static_cast<int>(e);
  int can = 0;
  e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (!can) return static_cast<int>(cudaErrorPeerAccessUnsupported);
  e = cudaSetDevice(device);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();  // clear the sticky-free status it left
    e = cudaSuccess;
  }
  const cudaError_t back = cudaSetDevice(prev);
  return static_cast<int>(e != cudaSuccess ? e : back);
}

// CUDA IPC of the cross-process exchange (not kernel launches).  Each
// works on the caller's current device.

// Bytes of one IPC handle (cudaIpcMemHandle_t).
int exchange_ipc_handle_bytes(void) {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// A receive arena of `bytes` bytes in an allocation of its own.
int exchange_ipc_alloc(unsigned long long bytes, void** ptr) {
  return static_cast<int>(cudaMalloc(ptr, static_cast<size_t>(bytes)));
}

int exchange_ipc_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// The IPC handle of the allocation at `ptr`, written to `out`
// (exchange_ipc_handle_bytes() bytes).
int exchange_ipc_handle(void* ptr, void* out) {
  cudaIpcMemHandle_t h;
  const cudaError_t e = cudaIpcGetMemHandle(&h, ptr);
  if (e == cudaSuccess) memcpy(out, &h, sizeof h);
  return static_cast<int>(e);
}

// Map another process's allocation from its handle; `*ptr` is its base
// address in this process.
int exchange_ipc_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof h);
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

int exchange_ipc_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
