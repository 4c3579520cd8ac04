// Dense nearest-centre assignment (the Lloyd assignment step of the masked
// k-means fit that the bucketed LERN engine runs for every layer).
//
// Replaces the Pallas TPU kernel
// repro/kernels/kmeans_assign/kernel.py::kmeans_assign.
// Grid (ceil(N / 256), B): one block per 256 rows of one batch row, one
// thread per row.  The block first copies its batch row's K x D centre
// table into shared memory as f32 and computes |c_k|^2 once per centre;
// then each thread scans the K centres for argmin_k (|c_k|^2 - 2 x.c_k),
// keeping the first index on ties.  D is not padded (the TPU wrapper
// padded it to 128 lanes).  Inputs are f32 or bf16 (converted to f32 on
// load); all arithmetic is f32.
//
// The sums follow XLA's CPU code for the JAX package's assignment
// (measured): |c|^2 is a fused multiply-add chain in ascending d; x.c is
// XLA's matrix-product order -- a fused multiply-add chain for D < 4, else
// four lane accumulators (lane l takes d = l, l+4, ...) combined as
// (l0 + l1) + (l2 + l3).  -fmad=false keeps nvcc from contracting any
// other product and sum, so the kernel, its plain PyTorch version and the
// reference agree bit for bit and break ties alike.
//
// Bound on the card: bytes (N x D inputs, N int32 outputs, a K x D table
// per batch row); at the path's shapes (N <= 32768, D <= 4, K = 4) the
// launch dominates.  No tensor cores: K = 4 is far below a wgmma tile.
//
// kmeans_fit (below) runs a whole masked Lloyd fit in one launch: the
// sweeps of ops.fit_masked_plain, which the JAX package runs inside one
// lax.scan around its Pallas assignment kernel.  See its comment.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float load(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load(const __nv_bfloat16* p, long long i) {
  return __bfloat162float(p[i]);
}

template <typename T>
__global__ void kmeans_assign_kernel(const T* __restrict__ x,
                                     const T* __restrict__ centers,
                                     int* __restrict__ out, int n, int k,
                                     int d) {
  extern __shared__ float smem[];
  float* c = smem;          // [k * d]
  float* c2 = smem + k * d; // [k]
  const int b = blockIdx.y;
  const T* cb = centers + static_cast<long long>(b) * k * d;
  for (int i = threadIdx.x; i < k * d; i += blockDim.x) c[i] = load(cb, i);
  __syncthreads();
  for (int j = threadIdx.x; j < k; j += blockDim.x) {
    const float* cj = c + j * d;
    float s = cj[0] * cj[0];
    for (int t = 1; t < d; ++t) s = __fmaf_rn(cj[t], cj[t], s);
    c2[j] = s;
  }
  __syncthreads();
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n) return;
  const long long base = (static_cast<long long>(b) * n + row) * d;
  int best = 0;
  float best_d = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float* cj = c + j * d;
    float xc;
    if (d < 4) {
      xc = load(x, base) * cj[0];
      for (int t = 1; t < d; ++t) xc = __fmaf_rn(load(x, base + t), cj[t], xc);
    } else {
      float l0 = load(x, base) * cj[0];
      float l1 = load(x, base + 1) * cj[1];
      float l2 = load(x, base + 2) * cj[2];
      float l3 = load(x, base + 3) * cj[3];
      for (int t = 4; t < d; t += 4) {
        l0 = __fmaf_rn(load(x, base + t), cj[t], l0);
        if (t + 1 < d) l1 = __fmaf_rn(load(x, base + t + 1), cj[t + 1], l1);
        if (t + 2 < d) l2 = __fmaf_rn(load(x, base + t + 2), cj[t + 2], l2);
        if (t + 3 < d) l3 = __fmaf_rn(load(x, base + t + 3), cj[t + 3], l3);
      }
      xc = (l0 + l1) + (l2 + l3);
    }
    const float dist = c2[j] - 2.0f * xc;
    if (j == 0 || dist < best_d) {
      best = j;
      best_d = dist;
    }
  }
  out[static_cast<long long>(b) * n + row] = best;
}

template <typename T>
int launch(const void* x, const void* centers, int* out, int b, int n, int k,
           int d, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(k) * (d + 1) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kmeans_assign_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((n + kThreads - 1) / kThreads, b);
  kmeans_assign_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(centers), out, n, k, d);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// kmeans_fit: `iters` Lloyd sweeps of the masked fit, one block per batch row
// ---------------------------------------------------------------------------
// Each sweep is ops.fit_masked_plain's, bit for bit:
//   * c2 = |c|^2 as a multiply-add chain over d and sc = c2 - 2 x.c with
//     x.c in XLA's matrix-product order (common.dot_fma / dot_lanes); every
//     multiply-add rounds as common.fma32 does (the exact product plus the
//     addend rounded to double, then to float), so the argmin (first index
//     on ties) is the plain version's;
//   * exact counts of the valid rows of each cluster;
//   * the sums one_hot.T @ x in ops._lloyd_sums's order.  A row adds
//     oh * x with oh 1 or 0 (so a non-member adds +0 or -0, as the plain
//     product does), each chain starts from -0 (the identity of IEEE
//     addition, so the first add gives the first row's value as cumsum
//     does).  D > 1: blocks of 256 rows, each added in row order (the
//     zero rows that pad the last block add +0 once), then the block
//     sums in block order.  D = 1: every row in order; for a batch of one
//     the lanes of ops._vector_sum (8, or 4 x 8 for 512 <= N < 4096),
//     folded and halved, then the rows past the last full step;
//   * new = sums / max(counts, 1), round-to-nearest division; an empty
//     cluster takes the valid row with the largest |x|^2 + min sc (the
//     first on ties; row 0 if no row is valid).
// The order of every add is fixed, so there are no atomics.  The longest
// chain of dependent adds bounds the kernel: at D = 4 (N = 32768) 256 + 128
// adds a sweep, at D = 1 with a batch of more than one row N adds.
//
// Block: 1024 threads.  Per sweep: each thread assigns rows (x from L2,
// the assignment kept in the `a` scratch, 0xff for a masked row), warps
// count with ballots and reduce the far-point candidate with shuffles;
// then the sums, staged in dynamic shared memory: D > 1 computes the
// partial sums of up to `chunk` 256-row blocks in parallel and k x d
// threads fold them in order; D = 1 writes each row's k products into
// shared memory a tile at a time and one thread per (lane, cluster) adds
// its chain.
constexpr int kFitThreads = 1024;
constexpr int kFitWarps = kFitThreads / 32;
constexpr int kMaxD = 16;  // ops.FIT_MAX_D
constexpr int kMaxK = 16;  // ops.FIT_MAX_K
constexpr int kSumBlock = 256;  // ops.LLOYD_SUM_BLOCK
constexpr int kDynBytes = 96 * 1024;
constexpr unsigned char kMasked = 0xff;

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

// common.dot_lanes: a chain for d < 4, else four lanes (lane l takes
// d = l, l + 4, ...) summed as (l0 + l1) + (l2 + l3)
template <int MD>
__device__ __forceinline__ float dot_lanes(const float (&xr)[MD],
                                           const float* c, int d) {
  if constexpr (MD < 4) {
    return dot_fma(xr, c, d);
  } else {
    if (d < 4) return dot_fma(xr, c, d);
    float l[4];
#pragma unroll
    for (int t = 0; t < 4; ++t) l[t] = __fmul_rn(xr[t], c[t]);
#pragma unroll
    for (int t = 4; t < MD; ++t)
      if (t < d) l[t & 3] = fma32(xr[t], c[t], l[t & 3]);
    return __fadd_rn(__fadd_rn(l[0], l[1]), __fadd_rn(l[2], l[3]));
  }
}

// the plain argmax: the larger score, the smaller row on ties
__device__ __forceinline__ void far_max(float& s, int& r, float s2, int r2) {
  if (s2 > s || (s2 == s && r2 < r)) {
    s = s2;
    r = r2;
  }
}

// D = 1: the products oh * x of tile t's rows (tile rows from t * tile,
// at most m) into half t % 2 of `dyn` ([2][k][tile]), threads `start`,
// `start + stride`, ...
template <int MK>
__device__ __forceinline__ void fill_tile(float* dyn, const float* x,
                                          const unsigned char* a, int t,
                                          int tile, int m, int k, int start,
                                          int stride) {
  const int t0 = t * tile, rows = min(tile, m - t0);
  float* dst = dyn + (t & 1) * k * tile;
  for (int i = start; i < rows; i += stride) {
    const float xv = x[t0 + i];
    const int ar = a[t0 + i];
#pragma unroll
    for (int j = 0; j < MK; ++j)
      if (j < k) dst[j * tile + i] = __fmul_rn(ar == j ? 1.0f : 0.0f, xv);
  }
}

// s + v[0] + v[1] + ... + v[rows - 1], in that order; the next eight
// values load while the current eight are added (v 16-byte aligned)
__device__ __forceinline__ float add_run(float s, const float* v, int rows) {
  const int r8 = rows & ~7;
  if (r8) {
    float4 q0 = reinterpret_cast<const float4*>(v)[0];
    float4 q1 = reinterpret_cast<const float4*>(v)[1];
    for (int i = 8; i <= r8; i += 8) {
      float4 n0 = q0, n1 = q1;
      if (i < r8) {
        n0 = reinterpret_cast<const float4*>(v + i)[0];
        n1 = reinterpret_cast<const float4*>(v + i)[1];
      }
      s = __fadd_rn(s, q0.x);
      s = __fadd_rn(s, q0.y);
      s = __fadd_rn(s, q0.z);
      s = __fadd_rn(s, q0.w);
      s = __fadd_rn(s, q1.x);
      s = __fadd_rn(s, q1.y);
      s = __fadd_rn(s, q1.z);
      s = __fadd_rn(s, q1.w);
      q0 = n0;
      q1 = n1;
    }
  }
  for (int i = r8; i < rows; ++i) s = __fadd_rn(s, v[i]);
  return s;
}

// KC, DC: k and d fixed when the kernel is compiled (the paths' k = 4 at
// d = 4 and d = 1), or 0 to take them from the arguments
template <int KC, int DC>
__global__ void __launch_bounds__(kFitThreads, 1)
    kmeans_fit_kernel(const float* __restrict__ xg,
                      const unsigned char* __restrict__ maskg,
                      const float* __restrict__ centers0,
                      float* __restrict__ out, unsigned char* ag, int n,
                      int k_arg, int d_arg, int iters, int vector_sum) {
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
  __shared__ float acc[32 * MK];
  __shared__ int far_row;
  extern __shared__ __align__(16) float dyn[];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long b = blockIdx.x;
  const float* x = xg + b * n * d;
  const unsigned char* mask = maskg + b * n;
  unsigned char* a = ag + b * n;
  const int kd = k * d;
  for (int i = tid; i < kd; i += kFitThreads) c[i] = centers0[b * kd + i];
  // D > 1: 256-row blocks, `chunk` blocks' partial sums in shared memory
  const int blk = n < kSumBlock ? n : kSumBlock;
  const int nb = (n + blk - 1) / blk;
  const int chunk = kDynBytes / (4 * kd);
  // D = 1: `lanes` chains per cluster over the first m rows, then the rest
  int lanes = 1, m = n;
  if (d == 1 && vector_sum && n >= 64) {
    lanes = (n >= 512 && n < 4096) ? 32 : 8;
    m = n / lanes * lanes;
  }
  const int tile = (kDynBytes / (8 * k)) & ~31;  // two tiles of k rows
  __syncthreads();

  for (int it = 0; it < iters; ++it) {
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
    for (int r0 = 0; r0 < n; r0 += kFitThreads) {
      const int row = r0 + tid;
      int best = kMasked;
      if (row < n) {
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
                c2[j], __fmul_rn(2.0f, dot_lanes(xr, c + j * d, d)));
            if (j == 0 || sc < best_d) {
              arg = j;
              best_d = sc;
            }
          }
        }
        const bool valid = mask[row] != 0;
        if (valid) best = arg;
        a[row] = static_cast<unsigned char>(best);
        far_max(best_score, best_row,
                valid ? __fadd_rn(dot_fma(xr, xr, d), best_d) : -INFINITY,
                row);
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
      float s = warp_score[lane];
      int r = warp_row[lane];
      for (int o = 16; o > 0; o >>= 1)
        far_max(s, r, __shfl_down_sync(0xffffffffu, s, o),
                __shfl_down_sync(0xffffffffu, r, o));
      if (lane == 0) far_row = r;
      if (lane < k) {
        int t = 0;
        for (int w = 0; w < kFitWarps; ++w) t += warp_cnt[w][lane];
        cnt[lane] = t;
      }
    }

    // 2. the sums, in ops._lloyd_sums's order
    if (d > 1) {
      float total = -0.0f;  // thread i < kd folds sums[i]
      for (int j0 = 0; j0 < nb; j0 += chunk) {
        const int nbc = min(chunk, nb - j0);
        __syncthreads();  // `a` written, the previous chunk folded
        for (int item = tid; item < nbc * d; item += kFitThreads) {
          const int jj = item / d, dd = item - jj * d;
          const int r0 = (j0 + jj) * blk, r1 = min(r0 + blk, n);
          float s[MK];
#pragma unroll
          for (int j = 0; j < MK; ++j) s[j] = -0.0f;
#pragma unroll 16
          for (int r = r0; r < r1; ++r) {
            const float xv = x[static_cast<long long>(r) * d + dd];
            const int ar = a[r];
#pragma unroll
            for (int j = 0; j < MK; ++j)
              if (j < k)
                s[j] = __fadd_rn(s[j], __fmul_rn(ar == j ? 1.0f : 0.0f, xv));
          }
#pragma unroll
          for (int j = 0; j < MK; ++j)
            if (j < k) {
              if (r0 + blk > n) s[j] = __fadd_rn(s[j], 0.0f);
              dyn[(jj * k + j) * d + dd] = s[j];
            }
        }
        __syncthreads();
        if (tid < kd) {
#pragma unroll 8
          for (int jj = 0; jj < nbc; ++jj)
            total = __fadd_rn(total, dyn[jj * kd + tid]);
        }
      }
      if (tid < kd) sums[tid] = total;
    } else {
      // each row's k products go to a shared-memory tile; the walkers (one
      // thread per lane and cluster) add tile t while the other warps fill
      // tile t + 1 into the other half
      const int chains = lanes * k;
      const int walkers = (chains + 31) & ~31;
      const int my_lane = tid % lanes, my_k = tid / lanes;
      const int ntiles = (m + tile - 1) / tile;
      float s = -0.0f;
      __syncthreads();  // `a` written
      fill_tile<MK>(dyn, x, a, 0, tile, m, k, tid, kFitThreads);
      for (int t = 0; t < ntiles; ++t) {
        __syncthreads();  // tile t filled, tile t - 1 added
        const int rows = min(tile, m - t * tile);
        if (tid < chains) {
          const float* v = dyn + ((t & 1) * k + my_k) * tile;
          if (lanes == 1) {
            s = add_run(s, v, rows);
          } else {
#pragma unroll 8
            for (int i = my_lane; i < rows; i += lanes) s = __fadd_rn(s, v[i]);
          }
        } else if (tid >= walkers && t + 1 < ntiles) {
          fill_tile<MK>(dyn, x, a, t + 1, tile, m, k, tid - walkers,
                        kFitThreads - walkers);
        }
      }
      if (tid < chains) acc[tid] = s;
      __syncthreads();
      if (tid < k) {
        float total;
        if (lanes == 1) {
          total = acc[tid];
        } else {
          float w[8];
#pragma unroll
          for (int l = 0; l < 8; ++l) w[l] = acc[tid * lanes + l];
          for (int q = 1; q < lanes / 8; ++q) {
#pragma unroll
            for (int l = 0; l < 8; ++l)
              w[l] = __fadd_rn(acc[tid * lanes + q * 8 + l], w[l]);
          }
#pragma unroll
          for (int h = 4; h > 0; h >>= 1) {
#pragma unroll
            for (int l = 0; l < h; ++l) w[l] = __fadd_rn(w[l], w[l + h]);
          }
          total = w[0];
        }
        for (int r = m; r < n; ++r)
          total = __fadd_rn(total, __fmul_rn(a[r] == tid ? 1.0f : 0.0f, x[r]));
        sums[tid] = total;
      }
    }
    __syncthreads();

    // 3. the update, and the reseed of an empty cluster
    for (int i = tid; i < kd; i += kFitThreads) {
      const int j = i / d;
      c[i] = cnt[j] > 0
                 ? __fdiv_rn(sums[i], fmaxf(static_cast<float>(cnt[j]), 1.0f))
                 : x[static_cast<long long>(far_row) * d + (i - j * d)];
    }
    __syncthreads();
  }
  for (int i = tid; i < kd; i += kFitThreads) out[b * kd + i] = c[i];
}

template <int KC, int DC>
int launch_fit(const float* x, const unsigned char* mask,
               const float* centers0, float* out, unsigned char* a, int b,
               int n, int k, int d, int iters, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kmeans_fit_kernel<KC, DC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kDynBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kmeans_fit_kernel<KC, DC><<<b, kFitThreads, kDynBytes, stream>>>(
      x, mask, centers0, out, a, n, k, d, iters, b == 1);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x [b, n, d] f32, mask [b, n] (bytes, nonzero = valid), centers0 and
// out [b, k, d] f32, a [b, n] bytes of scratch, all contiguous on the
// device; d <= 16, k <= 16.  Launches `iters` sweeps on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int kmeans_fit(const float* x, const unsigned char* mask,
                          const float* centers0, float* out, unsigned char* a,
                          int b, int n, int k, int d, int iters,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k == 4 && d == 4 && reinterpret_cast<uintptr_t>(x) % 16 == 0)
    return launch_fit<4, 4>(x, mask, centers0, out, a, b, n, k, d, iters, s);
  if (k == 4 && d == 1)
    return launch_fit<4, 1>(x, mask, centers0, out, a, b, n, k, d, iters, s);
  return launch_fit<0, 0>(x, mask, centers0, out, a, b, n, k, d, iters, s);
}

// x [b, n, d], centers [b, k, d] (f32, or bf16 when is_bf16), out [b, n]
// int32, all contiguous on the device.  Launches on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int kmeans_assign(const void* x, const void* centers, int* out,
                             int b, int n, int k, int d, int is_bf16,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? launch<__nv_bfloat16>(x, centers, out, b, n, k, d, s)
                 : launch<float>(x, centers, out, b, n, k, d, s);
}
