// Reuse-interval binning for the LERN features, one launch per call.
//
// Replaces the Pallas TPU kernel repro/kernels/ri_histogram/kernel.py::
// ri_histogram together with the sum of its per-block counts in the JAX
// wrapper (repro/kernels/ri_histogram/ops.py::histogram): bins[i] is -1
// where ri[i] < 0, else 0 / 1 / 2 / 3 for ri <= 10 / <= 100 / <= 500 /
// above; counts[j] is the number of elements in bin j (j = 0..3).
//
// Bound on the card: bytes, 4 read and 4 written per element (at the main
// path's N = 303,104, 2.4 MB: 0.72 us at 3.35 TB/s), so the launch is most
// of a call.  The design keeps a call to one launch with nothing that
// outlives it.  The grid is one thread-block cluster of kCluster CTAs (the
// size chosen by tools/ri_histogram_probe.py).  Each thread streams 16-byte
// vectors, kUnroll loads in flight before any store, and keeps four private
// counters; __reduce_add_sync folds them per warp and again per CTA, which
// leaves each CTA's four sums in its shared memory.  After cluster.sync()
// CTA 0 reads the other CTAs' sums through distributed shared memory and
// writes counts; a second cluster.sync() keeps every CTA (and its shared
// memory) alive until then.  No global atomics, no memset, no second
// kernel: integer counts are exact in any order.
//
// Elements before ri's first 16-byte boundary (a view such as ri[1:]) and
// a tail of fewer than four are binned one element a thread.  The vectors
// need bins at the same offset from a 16-byte boundary as ri: the wrapper
// allocates it so, and ri_histogram refuses other pointers.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;  // CTAs in the launch's one cluster
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 8;    // 16-byte loads in flight per thread
constexpr int kBins = 4;
constexpr long long kStride = static_cast<long long>(kCluster) * kThreads;
static_assert(kWarps == 32, "the CTA fold reads one warp sum per lane");

__device__ __forceinline__ int bin_of(int r, int (&c)[kBins]) {
  const int b = r < 0 ? -1 : r <= 10 ? 0 : r <= 100 ? 1 : r <= 500 ? 2 : 3;
#pragma unroll
  for (int j = 0; j < kBins; ++j) c[j] += b == j;
  return b;
}

__device__ __forceinline__ int4 bin4(int4 r, int (&c)[kBins]) {
  return make_int4(bin_of(r.x, c), bin_of(r.y, c), bin_of(r.z, c),
                   bin_of(r.w, c));
}

__global__ void __launch_bounds__(kThreads, 1)
    ri_histogram_kernel(const int* __restrict__ ri, int* __restrict__ bins,
                        int* __restrict__ counts, long long n) {
  __shared__ int warp_sums[kWarps][kBins];
  __shared__ int cta_sums[kBins];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const long long tid = static_cast<long long>(rank) * kThreads + threadIdx.x;
  int c[kBins] = {0, 0, 0, 0};

  // head: the elements before ri's first 16-byte boundary; nv: the
  // 16-byte vectors after them
  const uintptr_t addr = reinterpret_cast<uintptr_t>(ri);
  const long long head =
      min(n, static_cast<long long>((16 - addr % 16) % 16 / 4));
  const long long nv = (n - head) / 4;
  if (tid < head) bins[tid] = bin_of(ri[tid], c);

  const int4* src = reinterpret_cast<const int4*>(ri + head);
  int4* dst = reinterpret_cast<int4*>(bins + head);
  long long v = tid;
  for (; v + (kUnroll - 1) * kStride < nv; v += kUnroll * kStride) {
    int4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) x[u] = __ldg(src + v + u * kStride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[v + u * kStride] = bin4(x[u], c);
  }
  {
    int4 x[kUnroll] = {};
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v + u * kStride < nv) x[u] = __ldg(src + v + u * kStride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (v + u * kStride < nv) dst[v + u * kStride] = bin4(x[u], c);
  }
  const long long tail = head + 4 * nv + tid;  // the last n % 4 or fewer
  if (tail < n) bins[tail] = bin_of(ri[tail], c);

  // the counts: per warp, per CTA, then across the cluster
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < kBins; ++j) {
    const int s = __reduce_add_sync(0xffffffffu, c[j]);
    if (lane == 0) warp_sums[warp][j] = s;
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int j = 0; j < kBins; ++j) {
      const int s = __reduce_add_sync(0xffffffffu, warp_sums[lane][j]);
      if (lane == 0) cta_sums[j] = s;
    }
  }
  cluster.sync();
  if (rank == 0 && threadIdx.x < kBins) {
    int total = 0;
    for (int r = 0; r < kCluster; ++r)
      total += cluster.map_shared_rank(cta_sums, r)[threadIdx.x];
    counts[threadIdx.x] = total;
  }
  cluster.sync();
}

// The same launch with nothing to do: the floor of a call's time.
__global__ void __launch_bounds__(kThreads, 1) ri_histogram_empty_kernel() {}

// The launch shape: one cluster of kCluster CTAs on `stream`.  A cluster
// above the portable 8 CTAs needs the kernel's consent first.
struct ClusterLaunch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;

  template <typename Kernel>
  cudaError_t prepare(Kernel* kernel, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(kCluster);
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return kCluster > 8
               ? cudaFuncSetAttribute(
                     kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1)
               : cudaSuccess;
  }
};

template <typename... Args>
int launch(void (*kernel)(Args...), cudaStream_t stream, Args... args) {
  ClusterLaunch l;
  cudaError_t e = l.prepare(kernel, stream);
  if (e == cudaSuccess) e = cudaLaunchKernelEx(&l.cfg, kernel, args...);
  if (e != cudaSuccess) cudaGetLastError();
  return static_cast<int>(e);
}

}  // namespace

// ri, bins [n] int32 and counts [4] int32, contiguous on the device, n >= 1,
// bins at ri's offset from a 16-byte boundary.  Launches on `stream` and
// returns the launch's cudaError_t (0 on success).
extern "C" int ri_histogram(const int* ri, int* bins, int* counts, int n,
                            void* stream) {
  if ((reinterpret_cast<uintptr_t>(ri) ^ reinterpret_cast<uintptr_t>(bins)) %
          16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  return launch(ri_histogram_kernel, static_cast<cudaStream_t>(stream), ri,
                bins, counts, static_cast<long long>(n));
}

// The empty kernel, launched as ri_histogram is.
extern "C" int ri_histogram_empty(void* stream) {
  return launch(ri_histogram_empty_kernel, static_cast<cudaStream_t>(stream));
}

// size <- kCluster; active <- how many such clusters of the kernel the
// card can hold at once (cudaOccupancyMaxActiveClusters; 0: it cannot).
extern "C" int ri_histogram_cluster(int* size, int* active) {
  *size = kCluster;
  ClusterLaunch l;
  cudaError_t e = l.prepare(ri_histogram_kernel, nullptr);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveClusters(active, ri_histogram_kernel, &l.cfg);
  return static_cast<int>(e);
}
