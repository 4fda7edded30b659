// Verifier kernel for Hopper (sm_90a): one read of a shard's word planes.
//
// Replaces no Pallas kernel: the reference's fingerprint and sortedness
// check (mpitest_tpu/models/verify.py) are plain XLA reductions.  In
// PyTorch the same work was some 90 launches a one-rank call (XOR halving
// folds, an int64 cast copy before each sum, unsigned-order XORs,
// compares and boolean reductions) and a host read for each value.  This
// kernel does it in one pass.
//
// For 1 or 2 word planes (uint32 bits, plane 0 most significant) of one
// shard it writes one row of uint64 values, k = 4 * W + 1 wide:
//
//   [0, W)         XOR of words [0, n_fold), per plane
//   [W, 2W)        uint32 sum of words [0, n_fold), per plane (the row
//                  holds the sum of the blocks' uint32 partial sums; the
//                  host keeps its low 32 bits, the wrapping sum)
//   [2W]           1 if some pair (i, i + 1), i + 1 < n_sorted, is out of
//                  order (unsigned, lexicographic across the planes)
//   [2W+1, 3W+1)   the key at 0 (when the shard holds any word)
//   [3W+1, 4W+1)   the key at i_last (when i_last >= 0)
//
// The row must be zeroed before the launch: blocks add into it with
// atomics.  XOR and modular addition are exact and order-free, so the
// row is the same whatever order the blocks run in.
//
// Bound on the H100: bytes, one read of max(n_sorted, n_fold) words per
// plane (2^30 words: 4 GiB, 1.28 ms at 3.35 TB/s).  Each thread loads 16
// bytes a plane (uint4) in a grid-stride loop of about 4 blocks an SM,
// four vectors in flight a thread; the one word past a vector (for the
// pair that straddles vectors, warps and blocks) is a scalar load that
// the neighbouring thread's vector brought into L1.  Planes that lie the
// same number of words past a 16-byte boundary (a shard that starts
// inside a larger tensor) take their first 1-3 words one a thread, then
// the vectors; planes that lie at different offsets take the whole loop
// one word a thread.
// XOR, sum and the order flag stay in registers, then reduce over the
// warp (__shfl_xor_sync) and the block (shared memory); one thread a
// block adds them into the row.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kUnroll = 4;
constexpr int kMaxDevices = 64;

template <int W>
struct Planes {
  const uint32_t* p[W];
};

// a > b, unsigned and lexicographic, plane 0 most significant
template <int W>
__device__ __forceinline__ bool greater(const uint32_t (&a)[W], const uint32_t (&b)[W]) {
  bool gt = false, eq = true;
#pragma unroll
  for (int p = 0; p < W; ++p) {
    gt |= eq & (a[p] > b[p]);
    eq &= a[p] == b[p];
  }
  return gt;
}

template <int W>
struct Acc {
  uint32_t x[W];
  uint32_t s[W];
  unsigned bad;
};

// Words j0 .. j0 + 3 (v) and the word after them (nx, read only when
// j0 + 4 < n_sorted).
template <int W>
__device__ __forceinline__ void vec_step(const uint4 (&v)[W], const uint32_t (&nx)[W],
                                         long long j0, long long n_sorted,
                                         long long n_fold, Acc<W>& acc) {
  uint32_t k[5][W];
#pragma unroll
  for (int p = 0; p < W; ++p) {
    k[0][p] = v[p].x;
    k[1][p] = v[p].y;
    k[2][p] = v[p].z;
    k[3][p] = v[p].w;
    k[4][p] = nx[p];
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool in_fold = j0 + e < n_fold;
#pragma unroll
    for (int p = 0; p < W; ++p) {
      acc.x[p] ^= in_fold ? k[e][p] : 0u;
      acc.s[p] += in_fold ? k[e][p] : 0u;
    }
    acc.bad |= (j0 + e + 1 < n_sorted) & greater<W>(k[e], k[e + 1]);
  }
}

template <int W>
__device__ __forceinline__ void word_step(const Planes<W>& pl, long long j, long long n_sorted,
                                          long long n_fold, Acc<W>& acc) {
  uint32_t a[W];
#pragma unroll
  for (int p = 0; p < W; ++p) a[p] = __ldg(pl.p[p] + j);
  if (j < n_fold) {
#pragma unroll
    for (int p = 0; p < W; ++p) {
      acc.x[p] ^= a[p];
      acc.s[p] += a[p];
    }
  }
  if (j + 1 < n_sorted) {
    uint32_t b[W];
#pragma unroll
    for (int p = 0; p < W; ++p) b[p] = __ldg(pl.p[p] + j + 1);
    acc.bad |= greater<W>(a, b);
  }
}

// Vector q: words head + 4q .. head + 4q + 3, 16-byte aligned.
template <int W>
__device__ __forceinline__ void load_vec(const Planes<W>& pl, int head, long long q,
                                         long long n_sorted, uint4 (&v)[W], uint32_t (&nx)[W]) {
  const long long after = head + 4 * q + 4;
#pragma unroll
  for (int p = 0; p < W; ++p) {
    v[p] = __ldg(reinterpret_cast<const uint4*>(pl.p[p] + head) + q);
    nx[p] = after < n_sorted ? __ldg(pl.p[p] + after) : 0u;
  }
}

// kVec: words [0, head) one a thread, then vectors from word head (every
// plane 16-byte aligned there), then the last (n_read - head) % 4 words;
// else every word one a thread.
template <int W, bool kVec>
__global__ void __launch_bounds__(kThreads)
    verify_scan_kernel(Planes<W> pl, long long n_sorted, long long n_fold, long long i_last,
                       int head, unsigned long long* __restrict__ row) {
  Acc<W> acc;
#pragma unroll
  for (int p = 0; p < W; ++p) acc.x[p] = acc.s[p] = 0u;
  acc.bad = 0u;
  const long long n_read = n_sorted > n_fold ? n_sorted : n_fold;
  const long long tid = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if (kVec) {
    if (tid < head) word_step<W>(pl, tid, n_sorted, n_fold, acc);
    const long long n_vec = (n_read - head) / 4;
    long long q = tid;
    for (; q + (kUnroll - 1) * stride < n_vec; q += kUnroll * stride) {
      uint4 v[kUnroll][W];
      uint32_t nx[kUnroll][W];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        load_vec<W>(pl, head, q + u * stride, n_sorted, v[u], nx[u]);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        vec_step<W>(v[u], nx[u], head + 4 * (q + u * stride), n_sorted, n_fold, acc);
      }
    }
    for (; q < n_vec; q += stride) {
      uint4 v[W];
      uint32_t nx[W];
      load_vec<W>(pl, head, q, n_sorted, v, nx);
      vec_step<W>(v, nx, head + 4 * q, n_sorted, n_fold, acc);
    }
    const long long j = head + 4 * n_vec + tid;   // the last (n_read - head) % 4 words
    if (j < n_read) word_step<W>(pl, j, n_sorted, n_fold, acc);
  } else {
    for (long long j = tid; j < n_read; j += stride) word_step<W>(pl, j, n_sorted, n_fold, acc);
  }

#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int p = 0; p < W; ++p) {
      acc.x[p] ^= __shfl_xor_sync(0xffffffffu, acc.x[p], off);
      acc.s[p] += __shfl_xor_sync(0xffffffffu, acc.s[p], off);
    }
    acc.bad |= __shfl_xor_sync(0xffffffffu, acc.bad, off);
  }
  __shared__ uint32_t part[kWarps][2 * W + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (lane == 0) {
#pragma unroll
    for (int p = 0; p < W; ++p) {
      part[warp][p] = acc.x[p];
      part[warp][W + p] = acc.s[p];
    }
    part[warp][2 * W] = acc.bad;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kWarps; ++w) {
#pragma unroll
      for (int p = 0; p < W; ++p) {
        acc.x[p] ^= part[w][p];
        acc.s[p] += part[w][W + p];
      }
      acc.bad |= part[w][2 * W];
    }
#pragma unroll
    for (int p = 0; p < W; ++p) {
      if (acc.x[p]) atomicXor(row + p, static_cast<unsigned long long>(acc.x[p]));
      if (acc.s[p]) atomicAdd(row + W + p, static_cast<unsigned long long>(acc.s[p]));
    }
    if (acc.bad) atomicOr(row + 2 * W, 1ull);
    if (blockIdx.x == 0) {
#pragma unroll
      for (int p = 0; p < W; ++p) {
        if (n_read > 0) row[2 * W + 1 + p] = pl.p[p][0];
        if (i_last >= 0) row[3 * W + 1 + p] = pl.p[p][i_last];
      }
    }
  }
}

int sm_count() {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices && cached[dev]) return cached[dev];
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < kMaxDevices) cached[dev] = sms;
  return sms;
}

template <int W>
cudaError_t launch(const void* p0, const void* p1, long long n_sorted, long long n_fold,
                   long long i_last, unsigned long long* row, cudaStream_t s) {
  Planes<W> pl;
  const void* ptrs[2] = {p0, p1};
  const uintptr_t off = reinterpret_cast<uintptr_t>(p0) % 16;
  bool vec = off % 4 == 0;   // int32 planes: word-aligned always
  for (int p = 0; p < W; ++p) {
    pl.p[p] = static_cast<const uint32_t*>(ptrs[p]);
    vec &= reinterpret_cast<uintptr_t>(ptrs[p]) % 16 == off;
  }
  const int sms = sm_count();
  if (sms <= 0) return cudaErrorInvalidDevice;
  const long long n_read = n_sorted > n_fold ? n_sorted : n_fold;
  // words before the first 16-byte boundary, at most n_read
  long long head = static_cast<long long>((16 - off) % 16 / 4);
  if (head > n_read) head = n_read;
  const long long work = vec ? (n_read - head) / 4 : n_read;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > static_cast<long long>(sms) * kBlocksPerSm) blocks = static_cast<long long>(sms) * kBlocksPerSm;
  if (blocks < 1) blocks = 1;
  if (vec) {
    verify_scan_kernel<W, true><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        pl, n_sorted, n_fold, i_last, static_cast<int>(head), row);
  } else {
    verify_scan_kernel<W, false><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        pl, n_sorted, n_fold, i_last, 0, row);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Fold and check one shard: n_planes (1 or 2) int32 planes of uint32 bits
// (p1 unused for one plane), the fold over words [0, n_fold), the order
// check over words [0, n_sorted), the keys at 0 and at i_last (-1: none)
// into row (uint64[4 * n_planes + 1], zeroed).  Reads max(n_sorted,
// n_fold) > 0 words of each plane.
int verify_scan(const void* p0, const void* p1, int n_planes, long long n_sorted,
                long long n_fold, long long i_last, void* row, void* stream) {
  const long long n_read = n_sorted > n_fold ? n_sorted : n_fold;
  if (n_planes < 1 || n_planes > 2 || n_sorted < 0 || n_fold < 0 || n_read < 1
      || i_last < -1 || i_last >= n_read) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  unsigned long long* r = static_cast<unsigned long long*>(row);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err = n_planes == 1
      ? launch<1>(p0, p1, n_sorted, n_fold, i_last, r, s)
      : launch<2>(p0, p1, n_sorted, n_fold, i_last, r, s);
  return static_cast<int>(err);
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
