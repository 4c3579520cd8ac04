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
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

}  // namespace

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
