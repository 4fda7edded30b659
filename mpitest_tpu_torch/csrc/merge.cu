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
// Bound on the H100: operations, n^2 * K compares (67 M at n = 4096,
// K = 4, about 4 us at the 32-bit rate); a round is far too small for
// bytes to matter.  The work is spread over the card: the grid is
// ceil(n / 64) row blocks x 8 column splits, and the 8 CTAs of one row
// block form a thread-block cluster.  Each CTA stages its n / 8 columns
// in shared memory and ranks its 64 rows against them with 4 threads a
// row, each taking a quarter of the columns (the row's key in registers,
// K a template parameter, 1..8); the lanes of a warp share a column
// slice, so every column read is a broadcast.  The 4 partial ranks of a
// row are summed in shared memory; after a cluster barrier the cluster's
// first CTA sums the 8 CTAs' sums through distributed shared memory and
// writes order, and a second barrier keeps the other CTAs' shared memory
// alive until it has read.  No global atomics, one launch.  At n = 4096
// that is 512 CTAs of 256 threads, each thread doing 128 x K compares,
// against 16 blocks whose threads did 4096 x K before.
//
// The entry point launches on the caller's stream, allocates nothing, and
// returns cudaGetLastError() (0 on success).

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kRows = 64;                      // rows per CTA
constexpr int kSlices = 4;                     // threads a row, column slices
constexpr int kThreads = kRows * kSlices;
constexpr int kSplits = 8;                     // column splits = cluster size
constexpr int kMaxN = 4096;                    // the merge round envelope
constexpr int kMaxCols = kMaxN / kSplits;      // columns staged per CTA
constexpr int kMaxPlanes = 8;
static_assert(kRows % 32 == 0, "a warp's lanes share one column slice");

template <int K>
__global__ void __launch_bounds__(kThreads)
    merge_rank_cluster(const uint32_t* __restrict__ planes, int n,
                       int32_t* __restrict__ order) {
  __shared__ uint32_t cols[K][kMaxCols];
  __shared__ int part[kSlices][kRows];
  cg::cluster_group cluster = cg::this_cluster();
  const int split = static_cast<int>(cluster.block_rank());
  const int row = threadIdx.x % kRows;
  const int slice = threadIdx.x / kRows;
  const int i = blockIdx.y * kRows + row;
  const int span = (n + kSplits - 1) / kSplits;
  const int c0 = split * span;
  const int m = max(0, min(n, c0 + span) - c0);
  for (int t = threadIdx.x; t < m; t += kThreads) {
#pragma unroll
    for (int p = 0; p < K; ++p) cols[p][t] = planes[p * n + c0 + t];
  }
  uint32_t key[K];
#pragma unroll
  for (int p = 0; p < K; ++p) key[p] = i < n ? planes[p * n + i] : 0u;
  __syncthreads();
  int rank = 0;
  if (i < n) {
    const int per = (m + kSlices - 1) / kSlices;
    const int t0 = min(m, slice * per);
    const int t1 = min(m, t0 + per);
    // columns before row i count on ties, the others only when less
    const int before = min(m, max(0, i - c0));
#pragma unroll 4
    for (int t = t0; t < t1; ++t) {
      unsigned lt = 0, eq = 1;
#pragma unroll
      for (int p = 0; p < K; ++p) {
        const uint32_t b = cols[p][t];
        lt |= eq & (b < key[p]);
        eq &= b == key[p];
      }
      rank += lt | (eq & (t < before));
    }
  }
  part[slice][row] = rank;
  __syncthreads();
  if (slice == 0) {
#pragma unroll
    for (int s = 1; s < kSlices; ++s) rank += part[s][row];
    part[0][row] = rank;
  }
  cluster.sync();
  if (split == 0 && slice == 0 && i < n) {
    int total = 0;
#pragma unroll
    for (int r = 0; r < kSplits; ++r) total += cluster.map_shared_rank(&part[0][0], r)[row];
    order[total] = i;
  }
  cluster.sync();
}

template <int K>
cudaError_t launch(const uint32_t* planes, int n, int32_t* order, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSplits, (n + kRows - 1) / kRows, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kSplits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, merge_rank_cluster<K>, planes, n, order);
}

}  // namespace

extern "C" {

// K8: order (n int32) = the stable lexicographic sorting permutation of the
// n_planes uint32 planes stacked in planes (n_planes * n words, plane 0
// most significant), n <= 4096.
int merge_order(const void* planes, int n_planes, int n, void* order,
                void* stream) {
  if (n_planes < 1 || n_planes > kMaxPlanes || n < 1 || n > kMaxN) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint32_t* p = static_cast<const uint32_t*>(planes);
  int32_t* o = static_cast<int32_t*>(order);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (n_planes) {
    case 1: err = launch<1>(p, n, o, s); break;
    case 2: err = launch<2>(p, n, o, s); break;
    case 3: err = launch<3>(p, n, o, s); break;
    case 4: err = launch<4>(p, n, o, s); break;
    case 5: err = launch<5>(p, n, o, s); break;
    case 6: err = launch<6>(p, n, o, s); break;
    case 7: err = launch<7>(p, n, o, s); break;
    default: err = launch<8>(p, n, o, s); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
