// Shared pieces of the flash-attention forward and backward kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) for Hopper (sm_90a).
//
// Tiles are 64 query rows by 64 key columns, the whole head dimension D
// (16, 32, 64 or 128) resident; a block has 256 threads (8 warps). These
// are the port's own tiles, not the TPU's 512 x 512 (_BLOCK_TABLE): a
// block's shared memory holds at most 227 KB, and 64 x 64 tiles give
// B*H*S/64 blocks, enough to fill 132 SMs at the model's shapes.
//
// Every tile product goes through mm(): C (f32, shared) = A * B over
// tiles in shared memory. For bf16 and f16 operands it runs on the tensor
// cores through WMMA 16x16x16 fragments with f32 accumulation (one warp
// per 16x16 output fragment). For f32 operands it is true fp32 (FFMA, no
// TF32), the reference's HIGHEST precision: one thread per output element.
// The element-wise softmax math then reads C as plain f32 in shared
// memory, so the fragment layout never matters.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace mxt_flash {

constexpr int kBQ = 64;  // query rows per tile
constexpr int kBK = 64;  // key columns per tile
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// blocks per SM the compiler must allow for. Two cap 16-bit kernels at 128
// registers a thread, so that one block's loads overlap another's
// products; the f32 kernels keep their registers (capped, they spill).
template <typename T>
constexpr int kMinBlocks = sizeof(T) == 2 ? 2 : 1;
constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Row padding of the shared tiles. f32 tiles get an odd row length, so
// that threads reading one column of consecutive rows hit distinct banks;
// 16-bit tiles keep rows a multiple of 8 elements (WMMA's ldm) and of
// 16 bytes; the f32 scratch of the WMMA path a multiple of 4 floats.
template <typename T>
struct Pad {
  static constexpr int kOp = 8;
  static constexpr int kF = 4;
};
template <>
struct Pad<float> {
  static constexpr int kOp = 1;
  static constexpr int kF = 1;
};

// Element strides of a (B, H, S, D) view whose last dimension is
// contiguous.
struct View {
  int64_t sb, sh, ss;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// dst[r][d] = src row (row0 + r), r < 64; rows at or past S are zero.
// With `vec` (16-bit types whose rows start on 16-byte boundaries, see
// vec_ok) each thread moves 16 bytes at a time; else one element.
template <typename T, int D, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int64_t ss,
                                          int row0, int S, bool vec) {
  if constexpr (sizeof(T) == 2 && D % 8 == 0 && (LD * 2) % 16 == 0) {
    if (vec) {
      constexpr int kVec = D / 8;  // 16-byte vectors per row
      for (int idx = threadIdx.x; idx < 64 * kVec; idx += kThreads) {
        const int r = idx / kVec, c = (idx % kVec) * 8;
        const int s = row0 + r;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);  // 0.0 in bf16 and f16
        if (s < S)
          val = *reinterpret_cast<const uint4*>(src + (int64_t)s * ss + c);
        *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
      }
      return;
    }
  }
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = row0 + r;
    dst[r * LD + d] = s < S ? src[(int64_t)s * ss + d] : from_f32<T>(0.f);
  }
}

// C (M x N, f32, row stride ldc) = A (M x K) * B (K x N), all in shared
// memory. A is row-major (A[m*lda + k]) or column-major (A[m + k*lda]);
// B row-major (B[k*ldb + n]) or column-major (B[k + n*ldb]). M, N, K are
// multiples of 16. Callers synchronise around it.
template <typename T, bool kARow, bool kBRow, int M, int N, int K>
__device__ __forceinline__ void mm(float* C, int ldc, const T* A, int lda,
                                   const T* B, int ldb) {
  if constexpr (std::is_same<T, float>::value) {
    for (int idx = threadIdx.x; idx < M * N; idx += kThreads) {
      const int m = idx / N, n = idx % N;
      float acc = 0.f;
#pragma unroll 16
      for (int k = 0; k < K; ++k) {
        const float a = kARow ? A[m * lda + k] : A[m + k * lda];
        const float b = kBRow ? B[k * ldb + n] : B[k + n * ldb];
        acc = fmaf(a, b, acc);
      }
      C[m * ldc + n] = acc;
    }
  } else {
    using namespace nvcuda;
    using LA = typename std::conditional<kARow, wmma::row_major,
                                         wmma::col_major>::type;
    using LB = typename std::conditional<kBRow, wmma::row_major,
                                         wmma::col_major>::type;
    const int warp = threadIdx.x >> 5;
    for (int t = warp; t < (M / 16) * (N / 16); t += kWarps) {
      const int m0 = (t / (N / 16)) * 16, n0 = (t % (N / 16)) * 16;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
      for (int k0 = 0; k0 < K; k0 += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, T, LA> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, LB> b;
        wmma::load_matrix_sync(a, kARow ? A + m0 * lda + k0 : A + m0 + k0 * lda,
                               lda);
        wmma::load_matrix_sync(b, kBRow ? B + k0 * ldb + n0 : B + k0 + n0 * ldb,
                               ldb);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(C + m0 * ldc + n0, acc, ldc,
                              wmma::mem_row_major);
    }
  }
}

// Shared-memory layout common to both kernels: four 64 x D operand tiles,
// two 64 x 64 tiles (P and dS), two f32 scratch tiles (the forward uses
// one) and two per-row vectors. Every offset is a multiple of 128 bytes
// (WMMA needs 32). The largest, f32 with D 128 in the backward, is
// 231,936 bytes of the 232,448 a block may have.
template <typename T, int D>
struct Smem {
  static constexpr int kLdT = D + Pad<T>::kOp;
  static constexpr int kLdP = kBK + Pad<T>::kOp;
  static constexpr int kLdF = (D > kBK ? D : kBK) + Pad<T>::kF;
  static constexpr size_t kTile = 64 * kLdT * sizeof(T);
  static constexpr size_t kPTile = 64 * kLdP * sizeof(T);
  static constexpr size_t kA = 0, kB = kTile, kC = 2 * kTile, kD = 3 * kTile;
  static constexpr size_t kP = 4 * kTile, kDS = kP + kPTile;
  static constexpr size_t kF = kDS + kPTile;
  static constexpr size_t kG = kF + 64 * kLdF * sizeof(float);
  static constexpr size_t kRow0 = kG + 64 * kLdF * sizeof(float);
  static constexpr size_t kRow1 = kRow0 + 64 * sizeof(float);
  static constexpr size_t kBytes = kRow1 + 64 * sizeof(float);
  static_assert(kTile % 128 == 0 && kPTile % 128 == 0,
                "tiles must stay 128-byte aligned");
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

template <typename T>
__device__ __forceinline__ T* at(unsigned char* base, size_t off) {
  return reinterpret_cast<T*>(base + off);
}

// Sets the dynamic shared-memory limit of kernel `fn` and checks that the
// grid fits. Returns the first error.
template <typename Fn>
cudaError_t prepare(Fn fn, size_t bytes, int B, int H) {
  if ((int64_t)B * H > 65535) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline View view(const long long* s) { return View{s[0], s[1], s[2]}; }

// Whether every row of view `v` at `p` starts on a 16-byte boundary, so
// that load_tile may move 16 bytes at a time.
inline bool vec_ok(const void* p, View v, int elem_bytes) {
  const int64_t per = 16 / elem_bytes;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && v.sb % per == 0 &&
         v.sh % per == 0 && v.ss % per == 0;
}

}  // namespace mxt_flash
