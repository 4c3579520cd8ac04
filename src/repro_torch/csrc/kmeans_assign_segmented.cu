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
//
// kmeans_fit_segmented (below) runs every segment's whole Lloyd fit in one
// launch: the sweeps of ops.fit_segmented_plain.  See its comment.
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

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

// ---------------------------------------------------------------------------
// kmeans_fit_segmented: every segment's Lloyd fit, one block per segment
// ---------------------------------------------------------------------------
// A segment's Lloyd map reads only its own rows and centres, and a segment
// whose centres repeat (==) is at a fixed point that every later sweep
// reproduces bit for bit.  So each block sweeps its own segment until its
// centres repeat or `iters` sweeps ran, and writes how many it ran: the
// centres are those of ops.fit_segmented_plain, which sweeps all segments
// together until all repeat, and the fit's n_iter is the largest count.
//
// Each sweep is the plain sweep, bit for bit:
//   * the argmin over the segment's centres of c2 - 2 x.c, both
//     multiply-add chains over d rounded as common.fma32 does (the exact
//     product plus the addend rounded to double, then to float), the
//     first index on ties;
//   * each 8-row block's sums of oh * x (oh 1 or 0, so a non-member or a
//     pad row adds +0 or -0 as the plain product does) in row order from
//     -0 (the identity of IEEE addition), then the segment's block sums in
//     block order, then +0 once if the segment has fewer blocks than the
//     longest segment (`width`: the plain version pads its block table
//     with zero rows);
//   * exact counts; new = sums / max(counts, 1), round-to-nearest
//     division; an empty cluster takes the segment's valid row with the
//     largest |x|^2 + min sc, the smallest position on ties (row p - 1 of
//     the array if the segment has no valid row).
// No atomics: every add has its place in a fixed order.  The chain of
// dependent adds, 7 + width a sweep, bounds the kernel.
//
// Block: 1024 threads.  Per sweep: each thread assigns rows of the
// segment's run (the assignment in the `a` scratch, 0xff for a pad row),
// warps count with ballots and reduce the far-point candidate with
// shuffles; the block partial sums of up to `chunk` blocks go to dynamic
// shared memory, and k x d threads fold them in order.
constexpr int kFitThreads = 1024;
constexpr int kFitWarps = kFitThreads / 32;
constexpr int kMaxD = 16;  // ops.FIT_MAX_D
constexpr int kMaxK = 16;  // ops.FIT_MAX_K
constexpr int kDynBytes = 96 * 1024;
constexpr unsigned char kPad = 0xff;

// common.fma32: a * b + c with the product exact in double, the sum
// rounded to double, then to float
__device__ __forceinline__ float fma32(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn(a, b), c));
}

// common.dot_fma of a register row (MD >= d entries) and a shared-memory
// row
template <int MD>
__device__ __forceinline__ float dot_fma(const float (&xr)[MD],
                                         const float* c, int d) {
  float s = __fmul_rn(xr[0], c[0]);
#pragma unroll
  for (int t = 1; t < MD; ++t)
    if (t < d) s = fma32(xr[t], c[t], s);
  return s;
}

// the plain far point: the larger score, the smaller row on ties
__device__ __forceinline__ void far_max(float& s, int& r, float s2, int r2) {
  if (s2 > s || (s2 == s && r2 < r)) {
    s = s2;
    r = r2;
  }
}

// KC, DC: k and d fixed when the kernel is compiled (the path's k = 4, d =
// 4), or 0 to take them from the arguments
template <int KC, int DC>
__global__ void __launch_bounds__(kFitThreads, 1)
    kmeans_fit_segmented_kernel(const float* __restrict__ x,
                                const int* __restrict__ seg,
                                const int* __restrict__ layout,
                                const float* __restrict__ centers0,
                                float* __restrict__ out,
                                int* __restrict__ sweeps_out,
                                unsigned char* __restrict__ conv_out,
                                unsigned char* a, int p, int s, int k_arg,
                                int d_arg, int iters, int width) {
  constexpr int MK = KC ? KC : kMaxK;
  constexpr int MD = DC ? DC : kMaxD;
  const int k = KC ? KC : k_arg;
  const int d = DC ? DC : d_arg;
  __shared__ float c[MK * MD];
  __shared__ float c2[MK];
  __shared__ float sums[MK * MD];
  __shared__ int cnt[MK];
  __shared__ int warp_cnt[kFitWarps][MK];
  __shared__ float warp_score[kFitWarps];
  __shared__ int warp_row[kFitWarps];
  __shared__ int far_row;
  extern __shared__ __align__(16) float dyn[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sg = blockIdx.x;
  const int off = layout[sg];
  const int nbs = (layout[s + sg] + kSegBlock - 1) / kSegBlock;
  const int end = off + nbs * kSegBlock;
  const int kd = k * d;
  const long long cbase = static_cast<long long>(sg) * kd;
  const int chunk = kDynBytes / (4 * kd);
  for (int i = tid; i < kd; i += kFitThreads) c[i] = centers0[cbase + i];
  __syncthreads();

  int sweep = 0;
  int conv = 0;
  while (sweep < iters) {
    if (tid < k) {
      float cr[MD];
#pragma unroll
      for (int t = 0; t < MD; ++t) cr[t] = t < d ? c[tid * d + t] : 0.0f;
      c2[tid] = dot_fma(cr, c + tid * d, d);
    }
    __syncthreads();

    // 1. assignment, counts, the farthest valid row
    int my_cnt = 0;  // lane j < k counts cluster j over its warp's rows
    float best_score = -INFINITY;
    int best_row = INT_MAX;
    for (int r0 = off; r0 < end; r0 += kFitThreads) {
      const int row = r0 + tid;
      int best = kPad;
      if (row < end) {
        float xr[MD];
        if constexpr (DC == 4) {
          const float4 v = reinterpret_cast<const float4*>(x)[row];
          xr[0] = v.x;
          xr[1] = v.y;
          xr[2] = v.z;
          xr[3] = v.w;
        } else {
#pragma unroll
          for (int t = 0; t < MD; ++t)
            xr[t] = t < d ? x[static_cast<long long>(row) * d + t] : 0.0f;
        }
        float best_d = 0.0f;
        int arg = 0;
#pragma unroll
        for (int j = 0; j < MK; ++j) {
          if (j < k) {
            const float sc = __fsub_rn(
                c2[j], __fmul_rn(2.0f, dot_fma(xr, c + j * d, d)));
            if (j == 0 || sc < best_d) {
              arg = j;
              best_d = sc;
            }
          }
        }
        if (seg[row] < s) {
          best = arg;
          far_max(best_score, best_row,
                  __fadd_rn(dot_fma(xr, xr, d), best_d), row);
        }
        a[row] = static_cast<unsigned char>(best);
      }
#pragma unroll
      for (int j = 0; j < MK; ++j) {
        if (j < k) {
          const unsigned bal = __ballot_sync(0xffffffffu, best == j);
          if (lane == j) my_cnt += __popc(bal);
        }
      }
    }
    for (int o = 16; o > 0; o >>= 1)
      far_max(best_score, best_row,
              __shfl_down_sync(0xffffffffu, best_score, o),
              __shfl_down_sync(0xffffffffu, best_row, o));
    if (lane == 0) {
      warp_score[warp] = best_score;
      warp_row[warp] = best_row;
    }
    if (lane < k) warp_cnt[warp][lane] = my_cnt;
    __syncthreads();
    if (warp == 0) {
      float sc = warp_score[lane];
      int r = warp_row[lane];
      for (int o = 16; o > 0; o >>= 1)
        far_max(sc, r, __shfl_down_sync(0xffffffffu, sc, o),
                __shfl_down_sync(0xffffffffu, r, o));
      if (lane == 0) far_row = r == INT_MAX ? p - 1 : r;
      if (lane < k) {
        int t = 0;
        for (int w = 0; w < kFitWarps; ++w) t += warp_cnt[w][lane];
        cnt[lane] = t;
      }
    }

    // 2. the sums: 8-row blocks in row order, the blocks in order
    float total = -0.0f;  // thread i < kd folds sums[i]
    for (int j0 = 0; j0 < nbs; j0 += chunk) {
      const int nbc = min(chunk, nbs - j0);
      __syncthreads();  // `a` written, the previous chunk folded
      for (int item = tid; item < nbc * d; item += kFitThreads) {
        const int jj = item / d, dd = item - jj * d;
        const int r0 = off + (j0 + jj) * kSegBlock;
        float v[MK];
#pragma unroll
        for (int j = 0; j < MK; ++j) v[j] = -0.0f;
#pragma unroll
        for (int r = r0; r < r0 + kSegBlock; ++r) {
          const float xv = x[static_cast<long long>(r) * d + dd];
          const int ar = a[r];
#pragma unroll
          for (int j = 0; j < MK; ++j)
            if (j < k)
              v[j] = __fadd_rn(v[j], __fmul_rn(ar == j ? 1.0f : 0.0f, xv));
        }
#pragma unroll
        for (int j = 0; j < MK; ++j)
          if (j < k) dyn[(jj * k + j) * d + dd] = v[j];
      }
      __syncthreads();
      if (tid < kd) {
#pragma unroll 8
        for (int jj = 0; jj < nbc; ++jj)
          total = __fadd_rn(total, dyn[jj * kd + tid]);
      }
    }
    if (tid < kd) sums[tid] = nbs < width ? __fadd_rn(total, 0.0f) : total;
    __syncthreads();

    // 3. the update, the reseed of an empty cluster, the fixed-point test
    int same = 1;
    for (int i = tid; i < kd; i += kFitThreads) {
      const int j = i / d;
      const float nv =
          cnt[j] > 0
              ? __fdiv_rn(sums[i], fmaxf(static_cast<float>(cnt[j]), 1.0f))
              : x[static_cast<long long>(far_row) * d + (i - j * d)];
      same &= nv == c[i];
      c[i] = nv;
    }
    conv = __syncthreads_and(same);
    ++sweep;
    if (conv) break;
  }
  for (int i = tid; i < kd; i += kFitThreads) out[cbase + i] = c[i];
  if (tid == 0) {
    sweeps_out[sg] = sweep;
    conv_out[sg] = static_cast<unsigned char>(conv);
  }
}

template <int KC, int DC>
int launch_fit(const float* x, const int* seg, const int* layout,
               const float* centers0, float* out, int* sweeps,
               unsigned char* conv, unsigned char* a, int p, int s, int k,
               int d, int iters, int width, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kmeans_fit_segmented_kernel<KC, DC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, kDynBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kmeans_fit_segmented_kernel<KC, DC><<<s, kFitThreads, kDynBytes, stream>>>(
      x, seg, layout, centers0, out, sweeps, conv, a, p, s, k, d, iters,
      width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [p, d] f32 and seg [p] int32 in the flat-segmented layout (p % 8 ==
// 0), layout [2, s] int32 (each segment's first row, a multiple of 8, and
// its number of rows), centers0 and out [s, k, d] f32, sweeps [s] int32,
// conv [s] bytes, a [p] bytes of scratch, all contiguous on the device;
// d <= 16, k <= 16; width = the most 8-row blocks of any segment (at least
// 1).  Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int kmeans_fit_segmented(const float* x, const int* seg,
                                    const int* layout, const float* centers0,
                                    float* out, int* sweeps,
                                    unsigned char* conv, unsigned char* a,
                                    int p, int s, int k, int d, int iters,
                                    int width, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k == 4 && d == 4 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_fit<4, 4>(x, seg, layout, centers0, out, sweeps, conv, a,
                            p, s, k, d, iters, width, st);
  return launch_fit<0, 0>(x, seg, layout, centers0, out, sweeps, conv, a, p,
                          s, k, d, iters, width, st);
}

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
