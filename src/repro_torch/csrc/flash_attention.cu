// Forward attention with an online softmax over key blocks (causal or not,
// GQA by index).
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention (body
// _flash_kernel; wrapper ops.mha).  It computes what _flash_kernel computes:
//   s = (q . k) in f32, then times float32(d ** -0.5) (the scale is not
//   folded into q); causal entries with row < col (from position 0) are
//   set to -1e30; per key block of min(128, Sk) columns,
//   m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m - m_new),
//   l = l * alpha + rowsum(p), acc = acc * alpha + (p rounded to the input
//   type) . v, all in f32; out = acc / max(l, 1e-20) in q's type.
// Key blocks that lie wholly above the diagonal are skipped: there p = 0 and
// alpha = 1 exactly, so the result is the same.
//
// Layout: q [B, Sq, H, d], k and v [B, Sk, Hkv, d], out [B, Sq, H, d],
// contiguous, read strided (no transposes, K and V never repeated: q head h
// reads kv head h / (H / Hkv)).
//
// Grid (ceil(Sq / 64), B * H): one block per (batch * head, 64-row q tile),
// 256 threads as 16 x 16.  The Q tile, one K and one V block (converted to
// f32) and the block's p live in shared memory (194 KB at d = 128).  Thread
// (ty, tx) owns rows 4ty..4ty+3; it computes their scores at columns
// tx + 16j (j < 8) and their outputs at columns tx + 16j (j < d / 16), and
// the 16 threads of a row reduce its max and sum with warp shuffles.
//
// Bound on the card: operations.  Causal attention at Sq = Sk = S does
// 4 H d S^2 / 2 flops on 2 (B Sq H + 2 B Sk Hkv) d bytes of input and
// output, far above the card's ratio of flops to bytes.  This first version
// runs the products on the CUDA cores in f32 (register tiles of 4 x 8 over
// shared memory), far below the tensor cores' rate: a version with wgmma,
// TMA and a warp-specialised pipeline is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 128;       // the largest key block (the Pallas block_k)
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
// p.astype(v.dtype): round to the input type, then compute in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int D>
struct Smem {
  static constexpr int kQStride = D + 4;    // 2 rows of a warp: other banks
  static constexpr int kKStride = D + 1;    // 16 columns: 16 banks
  static constexpr int kPStride = kBK + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kQStride;
  static constexpr int kV = kK + kBK * kKStride;
  static constexpr int kP = kV + kBK * D;
  static constexpr int kFloats = kP + kBQ * kPStride;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk, int h,
          int hkv, int causal, float scale) {
  using S = Smem<D>;
  constexpr int kCols = D / 16;
  extern __shared__ float smem[];
  float* qs = smem + S::kQ;
  float* ks = smem + S::kK;
  float* vs = smem + S::kV;
  float* ps = smem + S::kP;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y;
  const int b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);
  const int q0 = blockIdx.x * kBQ;
  const int bk = sk < kBK ? sk : kBK;

  for (int i = tid; i < kBQ * D; i += kThreads) {
    const int r = i / D, j = i % D;
    const int row = q0 + r;
    qs[r * S::kQStride + j] =
        row < sq ? to_f32(q[((static_cast<long long>(b) * sq + row) * h + hh)
                               * D + j])
                 : 0.0f;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.0f;
  }

  // causal: the last key block needed is the one holding the tile's last row
  const int last_row = min(q0 + kBQ, sq) - 1;
  const int kend = causal ? min(sk, last_row + 1) : sk;
  for (int c0 = 0; c0 < kend; c0 += bk) {
    __syncthreads();   // the previous block's K, V and p are consumed
    for (int i = tid; i < kBK * D; i += kThreads) {
      const int c = i / D, j = i % D;
      float kx = 0.0f, vx = 0.0f;
      if (c < bk) {
        const long long g =
            ((static_cast<long long>(b) * sk + c0 + c) * hkv + kvh) * D + j;
        kx = to_f32(k[g]);
        vx = to_f32(v[g]);
      }
      ks[c * S::kKStride + j] = kx;
      vs[c * D + j] = vx;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < D; ++t) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * S::kQStride + t];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ks[(tx + 16 * j) * S::kKStride + t];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

    float alpha[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = tx + 16 * j;
        float x = s[i][j] * scale;
        if (c >= bk) {
          x = -INFINITY;            // no such column (Sk < 128): p = 0
        } else if (causal && row < c0 + c) {
          x = kNegInf;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = expf(s[i][j] - m_new);
        sum += p;
        ps[(ty * 4 + i) * S::kPStride + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();

    float pv[4][kCols];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) pv[i][j] = 0.0f;
    for (int c = 0; c < bk; ++c) {
      float pr[4], vv[kCols];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = ps[(ty * 4 + i) * S::kPStride + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) vv[j] = vs[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          pv[i][j] = __fmaf_rn(pr[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[i][j] = acc[i][j] * alpha[i] + pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-20f);
    T* out = o + ((static_cast<long long>(b) * sq + row) * h + hh) * D;
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      out[tx + 16 * j] = from_f32<T>(acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int b,
           int sq, int sk, int h, int hkv, int causal, float scale,
           cudaStream_t stream) {
  const size_t smem = Smem<D>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(
      flash_fwd<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((sq + kBQ - 1) / kBQ, b * h);
  flash_fwd<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), sq, sk, h, hkv, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, void* o, int b,
               int sq, int sk, int h, int hkv, int d, int causal, float scale,
               cudaStream_t s) {
  switch (d) {
    case 32:
      return launch<T, 32>(q, k, v, o, b, sq, sk, h, hkv, causal, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, b, sq, sk, h, hkv, causal, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, b, sq, sk, h, hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// q [b, sq, h, d], k and v [b, sk, hkv, d], o [b, sq, h, d] (f32, or bf16
// when is_bf16), contiguous on the device; d in {32, 64, 128}, h a multiple
// of hkv, sk a multiple of min(128, sk); scale = float32(d ** -0.5).
// Launches on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int sq, int sk, int h, int hkv,
                               int d, int causal, int is_bf16, float scale,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, o, b, sq, sk, h, hkv, d,
                                             causal, scale, s)
                 : dispatch_d<float>(q, k, v, o, b, sq, sk, h, hkv, d, causal,
                                     scale, s);
}
