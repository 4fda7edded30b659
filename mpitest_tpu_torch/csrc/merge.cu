// Merge-order kernel for Hopper (sm_90a).
//
// Replaces the Pallas kernel of mpitest_tpu/ops/radix_pallas.py on the
// external sort's merge path:
//
//   K8 merge_order  <- _order_kernel behind _compile_merge_order (the
//                      pallas_call of merge_order, radix_pallas.py:296)
//
// One merge round of the external sort hands over the key planes of at
// most 4096 records: 1-2 key words plus the (run id, in-run position)
// tiebreak planes, plane 0 most significant, each a uint32 plane stacked
// row-major into planes[k * n]. The kernel writes the permutation that
// sorts them:
//
//   rank_i = #{j : key_j <lex key_i} + #{j < i : key_j == key_i}
//   order[rank_i] = i
//
// Compares are unsigned. With unique keys (the store guarantees them
// through the tiebreak planes) the second term is 0 and this is the
// reference's rank; with ties it orders them by index, so order equals
// the stable np.lexsort on every input and every row is written once.
// The reference pads n to a power of two with 0xFFFFFFFF keys and an iota
// in the last plane; this kernel works on the n real rows.
//
// Design: one thread per row i, 256 rows per block; the j side is staged
// through shared memory in tiles of 256 rows x K planes, which every lane
// of a warp reads at the same address (a broadcast, no bank conflicts).
// K is a template parameter (1..8), so the row's key stays in registers
// and the plane loop unrolls.
//
// Bound on the H100: operations, n^2 * K compares (67 M at n = 4096,
// K = 4, about 4 us at the 32-bit rate). At n = 4096 the grid is only 16
// blocks, so 16 of 132 SMs work: the kernel is latency-bound, and a round
// costs more in its launch, its two copies and the host sync than in the
// kernel. Splitting the j range over more blocks is the next step.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // rows per block = j rows per tile
constexpr int kMaxPlanes = 8;

template <int K>
__global__ void __launch_bounds__(kThreads)
    merge_rank(const uint32_t* __restrict__ planes, int n,
               int32_t* __restrict__ order) {
  __shared__ uint32_t tile[K][kThreads];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  uint32_t key[K];
#pragma unroll
  for (int p = 0; p < K; ++p) key[p] = i < n ? planes[p * n + i] : 0u;
  int rank = 0;
  for (int base = 0; base < n; base += kThreads) {
    const int j = base + threadIdx.x;
#pragma unroll
    for (int p = 0; p < K; ++p) tile[p][threadIdx.x] = j < n ? planes[p * n + j] : 0u;
    __syncthreads();
    const int m = min(kThreads, n - base);
    if (i < n) {
      for (int t = 0; t < m; ++t) {
        bool lt = false;
        bool eq = true;
#pragma unroll
        for (int p = 0; p < K; ++p) {
          const uint32_t b = tile[p][t];
          lt = lt || (eq && b < key[p]);
          eq = eq && b == key[p];
        }
        rank += (lt || (eq && base + t < i)) ? 1 : 0;
      }
    }
    __syncthreads();
  }
  if (i < n) order[rank] = i;
}

template <int K>
void launch(const uint32_t* planes, int n, int32_t* order, cudaStream_t s) {
  const int blocks = (n + kThreads - 1) / kThreads;
  merge_rank<K><<<blocks, kThreads, 0, s>>>(planes, n, order);
}

}  // namespace

extern "C" {

// K8: order (n int32) = the stable lexicographic sorting permutation of the
// n_planes uint32 planes stacked in planes (n_planes * n words, plane 0
// most significant).
int merge_order(const void* planes, int n_planes, int n, void* order,
                void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* p = static_cast<const uint32_t*>(planes);
  int32_t* o = static_cast<int32_t*>(order);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n_planes) {
    case 1: launch<1>(p, n, o, s); break;
    case 2: launch<2>(p, n, o, s); break;
    case 3: launch<3>(p, n, o, s); break;
    case 4: launch<4>(p, n, o, s); break;
    case 5: launch<5>(p, n, o, s); break;
    case 6: launch<6>(p, n, o, s); break;
    case 7: launch<7>(p, n, o, s); break;
    default: launch<8>(p, n, o, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
