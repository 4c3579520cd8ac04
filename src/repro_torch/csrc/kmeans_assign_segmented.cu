// Segment-blocked nearest-centre assignment (the Lloyd assignment step of
// the flat-segmented LERN k-means fit).
//
// Replaces the Pallas TPU kernel
// repro/kernels/kmeans_assign/kernel.py::kmeans_assign_segmented.
// One thread per row.  Rows come in SEG_BLOCK (8) row blocks that never
// straddle a segment, so each thread reads its block's segment id itself
// (seg[row & ~7], clamped to S-1; pad blocks carry S) in place of the TPU's
// scalar prefetch, then scans that segment's K x D centres for
// argmin_k (|c_k|^2 - 2 x.c_k) in true fp32, keeping the first index on
// ties.  Each sum is an explicit fused multiply-add chain in ascending d
// (the arithmetic XLA's CPU backend emits for the JAX package's
// assignment, and what the plain PyTorch version computes); -fmad=false
// keeps nvcc from contracting anything else.
//
// Bound on the card: bytes (about 24 B a row at D = 4: the row, its id
// and the output; the centre table is a few KB and stays in L1/L2).  At
// the main path's P of about 1e5 rows the launch dominates.
#include <cuda_runtime.h>

namespace {

constexpr int kSegBlock = 8;
constexpr int kThreads = 256;

__global__ void kmeans_assign_segmented_kernel(
    const float* __restrict__ x, const float* __restrict__ centers,
    const int* __restrict__ seg, int* __restrict__ out, int p, int s, int k,
    int d) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= p) return;
  int sg = seg[row & ~(kSegBlock - 1)];
  sg = sg < 0 ? 0 : (sg > s - 1 ? s - 1 : sg);
  const float* xr = x + static_cast<long long>(row) * d;
  const float* c = centers + static_cast<long long>(sg) * k * d;
  int best = 0;
  float best_d = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float* cj = c + j * d;
    float c2 = cj[0] * cj[0];
    float xc = xr[0] * cj[0];
    for (int t = 1; t < d; ++t) {
      c2 = __fmaf_rn(cj[t], cj[t], c2);
      xc = __fmaf_rn(xr[t], cj[t], xc);
    }
    const float dist = c2 - 2.0f * xc;
    if (j == 0 || dist < best_d) {
      best = j;
      best_d = dist;
    }
  }
  out[row] = best;
}

}  // namespace

// x [p, d] f32, centers [s, k, d] f32, seg [p] int32, out [p] int32, all
// contiguous on the device; p % 8 == 0.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int kmeans_assign_segmented(const float* x, const float* centers,
                                       const int* seg, int* out, int p, int s,
                                       int k, int d, void* stream) {
  const int blocks = (p + kThreads - 1) / kThreads;
  kmeans_assign_segmented_kernel<<<blocks, kThreads, 0,
                                   static_cast<cudaStream_t>(stream)>>>(
      x, centers, seg, out, p, s, k, d);
  return static_cast<int>(cudaGetLastError());
}
