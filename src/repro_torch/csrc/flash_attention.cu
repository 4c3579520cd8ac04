// Forward attention with an online softmax over key blocks (causal or not,
// GQA by index): two kernels behind one library.
//
// Replaces the Pallas TPU kernel
// repro/kernels/flash_attention/kernel.py::flash_attention (body
// _flash_kernel; wrapper ops.mha).  Both kernels compute what _flash_kernel
// computes:
//   s = (q . k) in f32, then times float32(d ** -0.5) (the scale is not
//   folded into q); causal entries with row < col (from position 0) are
//   set to -1e30; per key block of min(128, Sk) columns, visited in
//   ascending order from column 0,
//   m_new = max(m, rowmax(s)), p = exp(s - m_new), alpha = exp(m - m_new),
//   l = l * alpha + rowsum(p), acc = acc * alpha + (p rounded to the input
//   type) . v, all in f32 (expf, l summed from the f32 p); out = acc /
//   max(l, 1e-20) in q's type.
// Key blocks that lie wholly above the diagonal are skipped: there p = 0 and
// alpha = 1 exactly, so the result is the same.  The order of the key
// blocks is kept because the rounding of p depends on the running max at
// the moment its block is folded in.
//
// Layout: q [B, Sq, H, d], k and v [B, Sk, Hkv, d], out [B, Sq, H, d],
// contiguous, read strided (no transposes, K and V never repeated: q head h
// reads kv head h / (H / Hkv)).
//
// Which kernel takes which call (ops.route), at d in {32, 64, 128, 256}:
//   bf16 -> flash_fwd_sm90, the Hopper kernel (flash_attention_sm90 below);
//   f32  -> flash_fwd, on the CUDA cores (flash_attention below): its bar
//   (2e-5 against the plain version) rules out the TF32 tensor cores.
//
// Bound on the card: operations.  Causal attention at Sq = Sk = S does
// 4 H d S^2 / 2 flops on 2 (B Sq H + 2 B Sk Hkv) d bytes of input and
// output, far above the card's ratio of flops to bytes (about 295 bf16
// flops a byte).  So the bf16 kernel is built around the tensor cores:
//   * both products on wgmma, bf16 in and f32 accumulate: S = Q K^T as
//     m64n128k16 with Q and K in shared memory (K-major), O += P V with P
//     rounded to bf16 in registers (the S accumulator's register layout is
//     wgmma's A-fragment layout) and V read MN-major through wgmma's
//     transpose bit; O stays in registers for the whole key loop;
//   * TMA feeds a ring of kStages K/V stages (mbarrier full/empty pairs)
//     from one 4-d tensor map (d, heads, rows, batch) per operand, boxes of
//     [128 rows, 64 columns] with the 128-byte swizzle (d = 32: 32 columns,
//     64-byte swizzle) that the wgmma descriptors name; a d = 128 row
//     arrives as two boxes;
//   * one block per (batch * head, 128-row query tile): two consumer
//     warpgroups of 64 rows and a producer warpgroup whose one thread
//     issues the copies; setmaxnreg moves registers to the consumers;
//   * causal tiles launch with the most key blocks first;
//   * p rounds to bf16 as it does from the plain version's scores.  The
//     tensor cores sum q . k in another order than an f32 matrix product
//     (a fused multiply-add chain over d), so a few p near a bf16 rounding
//     midpoint would round the other way, and where p is a large share of
//     its row's l one such rounding moves an output by more than a bf16
//     ulp.  In rows whose l may stay under 1 / kTau, the kernel recomputes
//     by the chain (from the tiles in shared memory) the scores that may
//     hold a new running max, and those whose p > kTau l lies within a
//     bound of a midpoint; the bound (|q| max|k| in units of the caller's
//     `bound`) is calibrated on the card against this kernel's own scores.
// Softmax and the products do not overlap inside a warpgroup (each wgmma
// batch is waited for before the softmax reads it): the two consumer
// warpgroups overlap each other only as the scheduler interleaves them.
// At d = 256 the Hopper kernel runs one consumer warpgroup of 64 query rows
// and a ring of one K/V stage (Q [64, 256], K and V [128, 256]: 160 KiB of
// shared memory, where two stages would need 288 KiB); its O accumulator
// alone is 128 registers a thread, so it takes no setmaxnreg and has 255
// registers a thread; O += P V runs as two m64n128k16 halves.
// The f32 kernel: grid (ceil(Sq / BQ), B * H), 256 threads as 16 x 16; the
// Q tile, one K and one V block (in f32) and the block's p in shared memory
// (194 KB at d = 128); thread (ty, tx) owns rows BQ/16 ty .. BQ/16 ty +
// BQ/16 - 1, scores at columns tx + 16j and outputs at columns tx + 16j,
// products as f32 FMAs.  BQ = 64 rows up to d = 128; at d = 256, BQ = 32
// and one buffer holds the K block for the scores, then the V block for
// the product (178 KB), in the same order of operations.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kBK = 128;       // the largest key block (the Pallas block_k)
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;

// the input type is f32 (bf16 goes to the Hopper kernel)
__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
// p.astype(v.dtype): round to the input type, then compute in f32
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

template <int D>
struct Smem {
  static constexpr int kBQ = D <= 128 ? 64 : 32;   // query rows per block
  static constexpr int kRows = kBQ / 16;           // rows per thread
  // d = 256: K, then V, in one buffer (two would need 355 KB)
  static constexpr bool kOneBuffer = D > 128;
  static constexpr int kQStride = D + 4;    // 2 rows of a warp: other banks
  static constexpr int kKStride = D + 1;    // 16 columns: 16 banks
  static constexpr int kVStride = kOneBuffer ? kKStride : D;
  static constexpr int kPStride = kBK + 4;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBQ * kQStride;
  static constexpr int kV = kOneBuffer ? kK : kK + kBK * kKStride;
  static constexpr int kP = kV + kBK * kVStride;
  static constexpr int kFloats = kP + kBQ * kPStride;
  static constexpr size_t kBytes = sizeof(float) * kFloats;
  static_assert(kBytes <= 232448, "shared memory");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int sq, int sk, int h,
          int hkv, int causal, float scale) {
  using S = Smem<D>;
  constexpr int kCols = D / 16;
  constexpr int kBQ = S::kBQ;
  constexpr int kR = S::kRows;
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

  float m[kR], l[kR], acc[kR][kCols];
#pragma unroll
  for (int i = 0; i < kR; ++i) {
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
    // the block's K (and V, unless they share one buffer)
    auto load = [&](const T* __restrict__ src, float* dst, int stride) {
      for (int i = tid; i < kBK * D; i += kThreads) {
        const int c = i / D, j = i % D;
        dst[c * stride + j] =
            c < bk ? to_f32(src[((static_cast<long long>(b) * sk + c0 + c) *
                                     hkv + kvh) * D + j])
                   : 0.0f;
      }
    };
    load(k, ks, S::kKStride);
    if constexpr (!S::kOneBuffer) load(v, vs, S::kVStride);
    __syncthreads();

    float s[kR][8];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int t = 0; t < D; ++t) {
      float qv[kR], kv[8];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        qv[i] = qs[(ty * kR + i) * S::kQStride + t];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = ks[(tx + 16 * j) * S::kKStride + t];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = __fmaf_rn(qv[i], kv[j], s[i][j]);
    }

    float alpha[kR];
#pragma unroll
    for (int i = 0; i < kR; ++i) {
      const int row = q0 + ty * kR + i;
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
        ps[(ty * kR + i) * S::kPStride + tx + 16 * j] = round_to<T>(p);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      alpha[i] = expf(m[i] - m_new);
      l[i] = l[i] * alpha[i] + sum;
      m[i] = m_new;
    }
    __syncthreads();
    if constexpr (S::kOneBuffer) {
      load(v, vs, S::kVStride);   // the scores have read K
      __syncthreads();
    }

    float pv[kR][kCols];
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) pv[i][j] = 0.0f;
    for (int c = 0; c < bk; ++c) {
      float pr[kR], vv[kCols];
#pragma unroll
      for (int i = 0; i < kR; ++i)
        pr[i] = ps[(ty * kR + i) * S::kPStride + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        vv[j] = vs[c * S::kVStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kR; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          pv[i][j] = __fmaf_rn(pr[i], vv[j], pv[i][j]);
    }
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        acc[i][j] = acc[i][j] * alpha[i] + pv[i][j];
  }

#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int row = q0 + ty * kR + i;
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
  const dim3 grid((sq + Smem<D>::kBQ - 1) / Smem<D>::kBQ, b * h);
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
    case 256:
      return launch<T, 256>(q, k, v, o, b, sq, sk, h, hkv, causal, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// The Hopper kernel (bf16, d in {32, 64, 128, 256}): wgmma for both
// products, a TMA-fed ring of K/V stages and a producer warpgroup.
// ---------------------------------------------------------------------------
namespace sm90 {

constexpr int kBN = 128;             // keys per block (the Pallas block_k)
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
// rows whose l may stay under 1 / kTau get p rounded exactly (see below)
constexpr float kTau = 1.0f / 1024.0f;
constexpr int kNoEncoder = -1;       // cuTensorMapEncodeTiled not found
constexpr int kBadTensorMap = -2;    // the driver refused a tensor map

// The block's shape and shared memory at head size D.  Up to d = 128: two
// consumer warpgroups (128 query rows) and a ring of two K/V stages; at
// d = 256 one consumer warpgroup (64 rows) and one stage, within the 227
// KB a block may take.  Each tile [rows, D] is kChunks column chunks of
// kSw bytes a row, as TMA writes them with the kSw-byte swizzle (the form
// wgmma reads): Q [kBM, D], then the K stages, then the V stages [128, D],
// then the barriers.  Tiles are 1024-byte aligned (the swizzle's repeat).
template <int D>
struct Layout {
  static constexpr int kWGs = D <= 128 ? 2 : 1;     // consumer warpgroups
  static constexpr int kStages = D <= 128 ? 2 : 1;  // K/V ring depth
  static constexpr int kBM = 64 * kWGs;             // query rows per block
  static constexpr int kThreads = 128 * (kWGs + 1); // and one producer
  static constexpr int kConsumerWarps = 4 * kWGs;
  static constexpr int kSw = D * 2 < 128 ? D * 2 : 128;   // bytes
  static constexpr int kBoxCols = kSw / 2;                 // elements
  static constexpr int kChunks = D / kBoxCols;
  static constexpr int kChunkBytes = kBN * kSw;            // K, V
  static constexpr int kQChunkBytes = kBM * kSw;
  static constexpr int kTile = kBN * D * 2;
  static constexpr int kQTile = kBM * D * 2;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQTile;
  static constexpr int kV = kK + kStages * kTile;
  static constexpr int kBar = kV + kStages * kTile;
  // q_full, k_full[kStages], v_full[kStages], empty[kStages]
  static constexpr int kBytes = 1024 + kBar + 8 * (1 + 3 * kStages);
  // descriptor layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kDescLayout = kSw == 128 ? 1 : 2;
  static_assert(kBytes <= 232448, "shared memory");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spin until the barrier's phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  } while (!done);
}

// One box of a 4-d tensor map (d, heads, rows, batch) into shared memory,
// completing `bytes` on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// A wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle layout type; base offset 0 (the tiles
// are aligned to the swizzle's repeat).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keep the compiler from moving reads or writes of wgmma's registers across
// the asynchronous region (the accumulators are written by the tensor
// cores between issue and wait).
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D[64 x 128] (+)= A . B, A and B from shared memory (descriptors)
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 32] += A . B, A from registers (four bf16 pairs a thread),
// B from shared memory, read MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] += A . B, A from registers (four bf16 pairs a thread),
// B from shared memory, read MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 128] += A . B, A from registers (four bf16 pairs a thread),
// B from shared memory, read MN-major (transposed)
__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a,
                                             uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}


template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t b) {
  if constexpr (N == 128) {
    wgmma_rs_n128(d, a, b);
  } else if constexpr (N == 64) {
    wgmma_rs_n64(d, a, b);
  } else {
    wgmma_rs_n32(d, a, b);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The 16-byte unit u of column chunk c of row `row` of a tile whose
// chunks are `chunk` bytes apart, where TMA's swizzle put it (the unit
// index XOR the row's position in its repeat).
template <int D>
__device__ __forceinline__ uint32_t unit_addr(uint32_t tile, int chunk,
                                              int row, int c, int u) {
  using L = Layout<D>;
  const int sw = L::kSw == 128 ? (row & 7) : ((row >> 1) & 3);
  return tile + c * chunk + row * L::kSw + ((u ^ sw) << 4);
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// bf16 -> f32 of the low and the high half of a word (exact)
__device__ __forceinline__ float bf_lo(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(uint32_t w) {
  return __uint_as_float(w & 0xFFFF0000u);
}

// Row a of tile ta dotted with row b of tile tb (chunks ca and cb bytes
// apart) in f32 as one chain of fused multiply-adds over d = 0 .. D-1, the
// order of a plain f32 matrix product; a row dotted with itself over one
// tile gives its squared norm in that order.
template <int D>
__device__ __forceinline__ float dot_chain(uint32_t ta, int ca, int a,
                                           uint32_t tb, int cb, int b) {
  using L = Layout<D>;
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < L::kChunks; ++c) {
#pragma unroll
    for (int u = 0; u < L::kSw / 16; ++u) {
      const uint4 x = ld_shared16(unit_addr<D>(ta, ca, a, c, u));
      const uint4 y = ld_shared16(unit_addr<D>(tb, cb, b, c, u));
      const uint32_t xs[4] = {x.x, x.y, x.z, x.w};
      const uint32_t ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        acc = __fmaf_rn(bf_lo(xs[w]), bf_lo(ys[w]), acc);
        acc = __fmaf_rn(bf_hi(xs[w]), bf_hi(ys[w]), acc);
      }
    }
  }
  return acc;
}

// Grid (B * H, ceil(Sq / kBM)), kThreads threads.  The last warpgroup is
// the producer: one thread loads the Q tile once and then each key block's
// K and V into the ring, waiting for a stage to be released before it
// refills it.  The others are kWGs consumer warpgroups of 64 query rows
// each; each key block they run S = Q K^T (wgmma, both operands in shared
// memory), the online softmax on S's registers, and O += P V (wgmma, P from
// registers, V read MN-major), then release the stage.
template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
flash_fwd_sm90(const __grid_constant__ CUtensorMap tm_q,
               const __grid_constant__ CUtensorMap tm_k,
               const __grid_constant__ CUtensorMap tm_v,
               __nv_bfloat16* __restrict__ o,
               const float* __restrict__ kmax, int sq, int sk, int h,
               int hkv, int causal, float scale, float bound) {
  using L = Layout<D>;
  constexpr int kStages = L::kStages;
  constexpr int kBM = L::kBM;
  constexpr int kSteps = D / 16;       // k16 steps of S = Q K^T
  constexpr int kPSteps = kBN / 16;    // k16 steps of O += P V
  constexpr int kPVN = D < 128 ? D : 128;   // columns of O a PV wgmma
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_tile = base + L::kQ;
  const uint32_t bar_q = base + L::kBar;
  auto bar_k = [&](int s) { return bar_q + 8u * (1 + s); };
  auto bar_v = [&](int s) { return bar_q + 8u * (1 + kStages + s); };
  auto bar_empty = [&](int s) { return bar_q + 8u * (1 + 2 * kStages + s); };
  auto k_tile = [&](int s) { return base + L::kK + s * L::kTile; };
  auto v_tile = [&](int s) { return base + L::kV + s * L::kTile; };

  const int bh = blockIdx.x;
  const int b = bh / h, hh = bh % h;
  const int kvh = hh / (h / hkv);
  // causal: the tiles with the most key blocks first
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * kBM;
  const int last_row = min(q0 + kBM, sq) - 1;
  const int kend = causal ? min(sk, last_row + 1) : sk;
  const int n_blocks = (kend + kBN - 1) / kBN;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k(s), 1);
      mbar_init(bar_v(s), 1);
      mbar_init(bar_empty(s), L::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == L::kWGs) {
    // producer warpgroup: registers go to the consumers (two of them; one
    // alone has 255 a thread without); one thread issues
    if constexpr (L::kWGs == 2) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
          kProducerRegs));
    }
    if (threadIdx.x == L::kWGs * 128) {
      mbar_expect_tx(bar_q, L::kQTile);
#pragma unroll
      for (int c = 0; c < L::kChunks; ++c)
        tma_load(q_tile + c * L::kQChunkBytes, &tm_q, c * L::kBoxCols, hh,
                 q0, b, bar_q);
      for (int i = 0; i < n_blocks; ++i) {
        const int st = i % kStages;
        mbar_wait(bar_empty(st), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(bar_k(st), L::kTile);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(k_tile(st) + c * L::kChunkBytes, &tm_k, c * L::kBoxCols,
                   kvh, i * kBN, b, bar_k(st));
        mbar_expect_tx(bar_v(st), L::kTile);
#pragma unroll
        for (int c = 0; c < L::kChunks; ++c)
          tma_load(v_tile(st) + c * L::kChunkBytes, &tm_v, c * L::kBoxCols,
                   kvh, i * kBN, b, bar_v(st));
      }
    }
    return;
  }

  if constexpr (L::kWGs == 2) {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        kConsumerRegs));
  }
  const int t = threadIdx.x % 128;
  const int warp = t / 32, lane = t % 32;
  // this thread's rows of the accumulators: r_lo and r_lo + 8 (tile rows
  // t_lo and t_lo + 8); its columns in each 8-column group: c_lane and
  // c_lane + 1
  const int t_lo = wg * 64 + warp * 16 + lane / 4;
  const int r_lo = q0 + t_lo;
  const int c_lane = 2 * (lane % 4);
  const uint32_t q_rows = q_tile + wg * 64 * L::kSw;
  // any column of a block can lie above this warpgroup's first row
  const int row_min = q0 + wg * 64;
  // element idx of s: its row in the tile and its column in the block
  auto row_of = [&](int idx) { return t_lo + 8 * ((idx & 3) >> 1); };
  auto col_of = [&](int idx) { return 8 * (idx >> 2) + c_lane + (idx & 1); };

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m_lo = kNegInf, m_hi = kNegInf, l_lo = 0.0f, l_hi = 0.0f;

  mbar_wait(bar_q, 0);
  // The bound on |s (wgmma) - s (f32 chain)| * scale for this thread's
  // rows, bound x |q| x max |k| (see flash_attention_sm90), and the same
  // bound as a window of w f32 ulps of p = exp(x - m) around a bf16
  // rounding midpoint (p / ulp(p) < 2^24, and 16 ulps for the rounding of
  // x - m and of expf): p's low 16 bits lie in [0x8000 - w, 0x8000 + w]
  // iff (bits << 16) + ofs <= lim, unsigned.
  const float kq = bound * kmax[b * hkv + kvh];
  constexpr int kQC = L::kQChunkBytes, kKC = L::kChunkBytes;
  const float e_lo =
      kq * sqrtf(dot_chain<D>(q_tile, kQC, t_lo, q_tile, kQC, t_lo));
  const float e_hi = kq * sqrtf(dot_chain<D>(q_tile, kQC, t_lo + 8, q_tile,
                                             kQC, t_lo + 8));
  const uint32_t w_lo =
      static_cast<uint32_t>(fminf(e_lo * 16777216.0f + 16.0f, 32767.0f));
  const uint32_t w_hi =
      static_cast<uint32_t>(fminf(e_hi * 16777216.0f + 16.0f, 32767.0f));
  const uint32_t ofs_lo = (w_lo - 0x8000u) << 16, lim_lo = (2 * w_lo) << 16;
  const uint32_t ofs_hi = (w_hi - 0x8000u) << 16, lim_hi = (2 * w_hi) << 16;

  for (int i = 0; i < n_blocks; ++i) {
    const int st = i % kStages;
    const uint32_t phase = (i / kStages) & 1;
    const int c0 = i * kBN;

    // S = Q K^T: [64, 128] in f32, K-major operands
    float s[kBN / 2];
#pragma unroll
    for (int j = 0; j < kBN / 2; ++j) s[j] = 0.0f;
    mbar_wait(bar_k(st), phase);
    fence_regs<kBN / 2>(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
      const uint32_t col = (kk * 16 % L::kBoxCols) * 2;
      const uint32_t chunk = kk * 16 / L::kBoxCols;
      wgmma_ss_n128(s,
                    desc(q_rows + chunk * kQC + col, 16, 8 * L::kSw,
                         L::kDescLayout),
                    desc(k_tile(st) + chunk * kKC + col, 16, 8 * L::kSw,
                         L::kDescLayout),
                    kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kBN / 2>(s);

    // x = s * scale, then the masks: -1e30 where row < col (causal), -inf
    // at columns past Sk (Sk < 128: those are zero rows that TMA filled).
    // Element idx = 4 j + e of s is row r_lo + 8 (e / 2), column
    // c0 + 8 j + c_lane + e % 2.
    const bool need_mask =
        (causal && c0 + kBN - 1 > row_min) || c0 + kBN > sk;
    float mx_lo = -INFINITY, mx_hi = -INFINITY;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[4 * j + e] * scale;
        if (need_mask) {
          const int col = c0 + 8 * j + c_lane + (e & 1);
          const int row = r_lo + (e >> 1) * 8;
          if (col >= sk) {
            x = -INFINITY;
          } else if (causal && row < col) {
            x = kNegInf;
          }
        }
        s[4 * j + e] = x;
        if (e < 2) {
          mx_lo = fmaxf(mx_lo, x);
        } else {
          mx_hi = fmaxf(mx_hi, x);
        }
      }
    }
    mx_lo = quad_max(mx_lo);
    mx_hi = quad_max(mx_hi);
    float mn_lo = fmaxf(m_lo, mx_lo), mn_hi = fmaxf(m_hi, mx_hi);
    float alpha_lo = expf(m_lo - mn_lo), alpha_hi = expf(m_hi - mn_hi);

    // Where one rounding of p to bf16 can move the output by more than
    // 2^-7 x kTau x |v| (a row whose l may stay under 1 / kTau), p must
    // round as it does from the f32 chain's s.  First the running max: if
    // this block may hold a new one, the elements within twice the bound
    // of the block's max are recomputed by the chain, and the largest of
    // them is the block's max.  (Rows past Sq are never stored.)
    const bool nm_lo = kTau * fmaxf(l_lo * alpha_lo, 1.0f) < 1.0f &&
                       mx_lo + e_lo >= m_lo && r_lo < sq;
    const bool nm_hi = kTau * fmaxf(l_hi * alpha_hi, 1.0f) < 1.0f &&
                       mx_hi + e_hi >= m_hi && r_lo + 8 < sq;
    if (__any_sync(0xffffffffu, nm_lo || nm_hi)) {
      uint64_t todo = 0;
#pragma unroll
      for (int idx = 0; idx < kBN / 2; ++idx) {
        const bool hi = (idx & 3) >= 2;
        if ((hi ? nm_hi : nm_lo) &&
            s[idx] >= (hi ? mx_hi - 2.0f * e_hi : mx_lo - 2.0f * e_lo)) {
          todo |= 1ull << idx;
        }
      }
      float ex_lo = -INFINITY, ex_hi = -INFINITY;
      for (; todo != 0; todo &= todo - 1) {
        const int idx = __ffsll(static_cast<long long>(todo)) - 1;
        const float x = dot_chain<D>(q_tile, kQC, row_of(idx), k_tile(st),
                                     kKC, col_of(idx)) *
                        scale;
        if ((idx & 3) >= 2) {
          ex_hi = fmaxf(ex_hi, x);
        } else {
          ex_lo = fmaxf(ex_lo, x);
        }
      }
      ex_lo = quad_max(ex_lo);
      ex_hi = quad_max(ex_hi);
      if (nm_lo) mx_lo = ex_lo;
      if (nm_hi) mx_hi = ex_hi;
      mn_lo = fmaxf(m_lo, mx_lo);
      mn_hi = fmaxf(m_hi, mx_hi);
      alpha_lo = expf(m_lo - mn_lo);
      alpha_hi = expf(m_hi - mn_hi);
    }

    // p = exp(x - m_new) in f32, summed in f32; the copy fed to P V is
    // rounded to bf16 in the A-fragment layout (pf[4 t .. 4 t + 3] is the
    // fragment of keys 16 t .. 16 t + 15).  In the rows named above, an
    // element whose p > kTau x l lies within the bound of a rounding
    // midpoint of bf16 is marked in `redo`.
    const float thr_lo = kTau * fmaxf(l_lo * alpha_lo, 1.0f);
    const float thr_hi = kTau * fmaxf(l_hi * alpha_hi, 1.0f);
    uint32_t pf[kBN / 4];
    float sum_lo = 0.0f, sum_hi = 0.0f;
    uint64_t redo = 0;
    auto fold = [&](auto check) {
#pragma unroll
      for (int j = 0; j < kBN / 8; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          p[e] = expf(s[4 * j + e] - (e < 2 ? mn_lo : mn_hi));
          if constexpr (decltype(check)::value) {
            const uint32_t near =
                __float_as_uint(p[e]) * 65536u + (e < 2 ? ofs_lo : ofs_hi);
            if (near <= (e < 2 ? lim_lo : lim_hi) &&
                p[e] > (e < 2 ? thr_lo : thr_hi)) {
              redo |= 1ull << (4 * j + e);
            }
          }
        }
        sum_lo += p[0];
        sum_lo += p[1];
        sum_hi += p[2];
        sum_hi += p[3];
        pf[2 * j] = pack_bf16(p[0], p[1]);
        pf[2 * j + 1] = pack_bf16(p[2], p[3]);
      }
    };
    if (__any_sync(0xffffffffu, thr_lo < 1.0f || thr_hi < 1.0f)) {
      fold(std::true_type{});
    } else {
      fold(std::false_type{});
    }
    // p of element idx from the chain's x, rounded into its fragment
    auto patch = [&](int idx, float x) {
      const uint32_t bits = __bfloat16_as_ushort(
          __float2bfloat16_rn(expf(x - ((idx & 3) >= 2 ? mn_hi : mn_lo))));
      const int word = 2 * (idx >> 2) + ((idx & 3) >> 1);
#pragma unroll
      for (int j = 0; j < kBN / 4; ++j) {
        if (j == word) {
          pf[j] = (idx & 1) ? (pf[j] & 0xFFFFu) | (bits << 16)
                            : (pf[j] & 0xFFFF0000u) | bits;
        }
      }
    };
    for (; redo != 0; redo &= redo - 1) {
      const int idx = __ffsll(static_cast<long long>(redo)) - 1;
      patch(idx, dot_chain<D>(q_tile, kQC, row_of(idx), k_tile(st), kKC,
                              col_of(idx)) *
                     scale);
    }
    l_lo = l_lo * alpha_lo + quad_sum(sum_lo);
    l_hi = l_hi * alpha_hi + quad_sum(sum_hi);
    m_lo = mn_lo;
    m_hi = mn_hi;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha_lo;
      acc[4 * j + 1] *= alpha_lo;
      acc[4 * j + 2] *= alpha_hi;
      acc[4 * j + 3] *= alpha_hi;
    }

    // O += P V: V [128 keys, D] read MN-major (D contiguous), in wgmma's
    // of kPVN columns of O (d = 256: two halves, each two column chunks)
    mbar_wait(bar_v(st), phase);
    fence_regs<D / 2>(acc);
    fence_regs<kBN / 4>(pf);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kPSteps; ++kk) {
#pragma unroll
      for (int n = 0; n < D / kPVN; ++n)
        wgmma_rs<kPVN>(acc + n * (kPVN / 2), pf + 4 * kk,
                       desc(v_tile(st) + n * (kPVN / L::kBoxCols) * kKC +
                                kk * 16 * L::kSw,
                            kKC, 8 * L::kSw, L::kDescLayout));
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<D / 2>(acc);
    if (lane == 0) mbar_arrive(bar_empty(st));
  }

  // out = acc / max(l, 1e-20) in bf16
  const float den_lo = fmaxf(l_lo, 1e-20f), den_hi = fmaxf(l_hi, 1e-20f);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r_lo + 8 * half;
    if (row >= sq) continue;
    const float den = half ? den_hi : den_lo;
    __nv_bfloat16* out =
        o + ((static_cast<long long>(b) * sq + row) * h + hh) * D + c_lane;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(out + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * half] / den,
                                acc[4 * j + 2 * half + 1] / den);
  }
}

// cuTensorMapEncodeTiled is a driver-API function: it is looked up through
// the runtime (cudaGetDriverEntryPoint), so the library needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &status);
#endif
    if (e != cudaSuccess || status != cudaDriverEntryPointSuccess) {
      return nullptr;
    }
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// [batch, rows, heads, D] bf16, contiguous, as a 4-d map (D, heads, rows,
// batch) with [box_rows, kBoxCols] boxes: rows past the end of a sequence
// read as zeros, never as the next batch row's.
template <int D>
bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int heads,
              int rows, int batch, int box_rows) {
  using L = Layout<D>;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = 2ull * D;
  const cuuint64_t strides[3] = {row_bytes, row_bytes * heads,
                                 row_bytes * heads * rows};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(L::kBoxCols), 1,
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
             dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
             L::kSw == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                           : CU_TENSOR_MAP_SWIZZLE_64B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o,
           const float* kmax, int b, int sq, int sk, int h, int hkv,
           int causal, float scale, float bound, cudaStream_t stream) {
  const EncodeTiled enc = encoder();
  if (enc == nullptr) return kNoEncoder;
  CUtensorMap tm_q, tm_k, tm_v;
  using L = Layout<D>;
  if (!make_map<D>(enc, &tm_q, q, h, sq, b, L::kBM) ||
      !make_map<D>(enc, &tm_k, k, hkv, sk, b, kBN) ||
      !make_map<D>(enc, &tm_v, v, hkv, sk, b, kBN)) {
    return kBadTensorMap;
  }
  const int smem = L::kBytes;
  const cudaError_t e = cudaFuncSetAttribute(
      flash_fwd_sm90<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(b * h, (sq + L::kBM - 1) / L::kBM);
  flash_fwd_sm90<D><<<grid, L::kThreads, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), kmax, sq, sk, h,
      hkv, causal, scale, bound);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90

// q [b, sq, h, d], k and v [b, sk, hkv, d], o [b, sq, h, d], f32,
// contiguous on the device; d in {32, 64, 128, 256}, h a multiple of hkv,
// sk a multiple of min(128, sk); scale = float32(d ** -0.5).  Launches the
// CUDA-core kernel on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int b, int sq, int sk, int h, int hkv,
                               int d, int causal, float scale, void* stream) {
  return dispatch_d<float>(q, k, v, o, b, sq, sk, h, hkv, d, causal, scale,
                           static_cast<cudaStream_t>(stream));
}

// q [b, sq, h, d], k and v [b, sk, hkv, d], o [b, sq, h, d], bf16,
// contiguous and 16-byte aligned on the device; d in {32, 64, 128, 256}, h
// a multiple of hkv, sk a multiple of min(128, sk); scale = float32(d **
// -0.5).  kmax [b, hkv] (f32, on the device) bounds the norm of every key
// row of each kv head; bound x |q| x kmax bounds how far a scaled score
// from the tensor cores may lie from the f32 chain's.
// Launches the Hopper kernel on `stream` and returns cudaGetLastError() (0
// on success), -1 if the driver has no cuTensorMapEncodeTiled, -2 if it
// refused a tensor map.
extern "C" int flash_attention_sm90(const void* q, const void* k,
                                    const void* v, void* o, const void* kmax,
                                    int b, int sq, int sk, int h, int hkv,
                                    int d, int causal, float scale,
                                    float bound, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* km = static_cast<const float*>(kmax);
  switch (d) {
    case 32:
      return sm90::launch<32>(q, k, v, o, km, b, sq, sk, h, hkv, causal,
                              scale, bound, s);
    case 64:
      return sm90::launch<64>(q, k, v, o, km, b, sq, sk, h, hkv, causal,
                              scale, bound, s);
    case 128:
      return sm90::launch<128>(q, k, v, o, km, b, sq, sk, h, hkv, causal,
                               scale, bound, s);
    case 256:
      return sm90::launch<256>(q, k, v, o, km, b, sq, sk, h, hkv, causal,
                               scale, bound, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The dynamic shared memory a block of the Hopper kernel takes at head size
// d (bytes), or 0 for a head size it was not built for.
extern "C" int flash_attention_sm90_smem(int d) {
  switch (d) {
    case 32:
      return sm90::Layout<32>::kBytes;
    case 64:
      return sm90::Layout<64>::kBytes;
    case 128:
      return sm90::Layout<128>::kBytes;
    case 256:
      return sm90::Layout<256>::kBytes;
    default:
      return 0;
  }
}
