// Shared pieces of the flash-attention forward and backward kernels
// (flash_attention_fwd.cu, flash_attention_bwd.cu) for Hopper (sm_90a).
// They replace the Pallas kernels _fwd_kernel and _bwd_kernel of
// mxnet_tpu/ops/flash_attention.py (:143 and :298), which are bound by
// operations on the card: at the model's shapes (B 4, H 12, S 2048, D 64,
// causal) the forward needs 26 us and the backward 65 us at the tensor
// cores' 989 TFLOP/s.
//
// Two families of kernels share this header.
//
// bf16/f16 (the training path): tensor-core kernels in the FlashAttention-2
// register layout, which the first (WMMA) kernels' four limits shaped:
//   1. No product goes through shared memory in f32. Accumulators stay in
//      registers; the softmax works on them there (row max and sum over the
//      four threads of a row by quad shuffles); P (or dS) is rounded to the
//      input type in registers, where the accumulator layout of two 16 x 8
//      tiles is exactly the A-operand layout of one 16 x 16 step, and feeds
//      the next product from registers.
//   2. Products are wgmma (m64n64k16, asynchronous warpgroup products,
//      wgmma_ss/wgmma_rs) where rows are 128 bytes (D 64, the model's
//      head dim), else mma.sync.m16n8k16 with operands read by ldmatrix
//      (.trans where an operand is stored the other way round). Both are
//      inline PTX with f32 accumulation; a wgmma operand is a descriptor of
//      a shared tile, read through the transpose bit where it is stored
//      N- or M-major.
//   3. Copies run ahead of the products: cp.async (16 bytes a thread, zero
//      fill for rows at or past S) into a ring of stages, the next tile in
//      flight while the current one is multiplied. Rows of a view that are
//      not 16-byte aligned take plain loads inside the same kernels. TMA is
//      not used: a tensor map of every strided view would have to be
//      encoded on the host per call, and cp.async already keeps the copies
//      off the products' path.
//   4. Shared tiles are row-major and XOR-swizzled in 16-byte chunks (swz;
//      for rows of 128 bytes this is the hardware's 128-byte swizzle that
//      wgmma reads), so ldmatrix's and cp.async's eight rows fall in eight
//      bank groups without padding.
//
// f32 (the reference's HIGHEST precision, off the main path): the first
// kernels, kept as they are. Tiles of 64 x 64 in shared memory, products
// by mm() in true fp32 (FFMA, no TF32), one thread per output element.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace mxt_flash {

constexpr int kBQ = 64;  // query rows per tile (f32 kernels)
constexpr int kBK = 64;  // key columns per tile (f32 kernels)
constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // the reference's _NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

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

// ---------------------------------------------------------------------------
// f32 kernels: FFMA tiles in shared memory
// ---------------------------------------------------------------------------

// dst[r][d] = src row (row0 + r), r < 64; rows at or past S are zero.
template <int D, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          int64_t ss, int row0, int S) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += kThreads) {
    const int r = idx / D, d = idx % D;
    const int s = row0 + r;
    dst[r * LD + d] = s < S ? src[(int64_t)s * ss + d] : 0.f;
  }
}

// C (M x N, row stride ldc) = A (M x K) * B (K x N), all f32 in shared
// memory. A is row-major (A[m*lda + k]) or column-major (A[m + k*lda]);
// B row-major (B[k*ldb + n]) or column-major (B[k + n*ldb]). Callers
// synchronise around it.
template <bool kARow, bool kBRow, int M, int N, int K>
__device__ __forceinline__ void mm(float* C, int ldc, const float* A, int lda,
                                   const float* B, int ldb) {
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
}

// Shared-memory layout of the f32 kernels: four 64 x D operand tiles, two
// 64 x 64 tiles (P and dS), two scratch tiles (the forward uses one) and
// two per-row vectors. Rows have an odd length, so that threads reading
// one column of consecutive rows hit distinct banks. The largest, D 128 in
// the backward, is 231,936 bytes of the 232,448 a block may have.
template <int D>
struct Smem {
  static constexpr int kLdT = D + 1;
  static constexpr int kLdP = kBK + 1;
  static constexpr int kLdF = (D > kBK ? D : kBK) + 1;
  static constexpr size_t kTile = 64 * kLdT * sizeof(float);
  static constexpr size_t kPTile = 64 * kLdP * sizeof(float);
  static constexpr size_t kA = 0, kB = kTile, kC = 2 * kTile, kD = 3 * kTile;
  static constexpr size_t kP = 4 * kTile, kDS = kP + kPTile;
  static constexpr size_t kF = kDS + kPTile;
  static constexpr size_t kG = kF + 64 * kLdF * sizeof(float);
  static constexpr size_t kRow0 = kG + 64 * kLdF * sizeof(float);
  static constexpr size_t kRow1 = kRow0 + 64 * sizeof(float);
  static constexpr size_t kBytes = kRow1 + 64 * sizeof(float);
  static_assert(kBytes <= 232448, "more shared memory than a block has");
};

template <typename T>
__device__ __forceinline__ T* at(unsigned char* base, size_t off) {
  return reinterpret_cast<T*>(base + off);
}

// ---------------------------------------------------------------------------
// bf16/f16 kernels: tensor-core fragments, swizzled tiles, cp.async
// ---------------------------------------------------------------------------

// Element offset of (row, col) in a row-major tile of rows of W 16-bit
// elements, swizzled in 16-byte chunks of 8: chunk c of row r is stored
// at chunk c ^ f(r), where f spreads any 8 consecutive rows over the 8
// bank groups of 128 bytes. col % 8 is kept.
template <int W>
__device__ __forceinline__ int swz(int row, int col) {
  constexpr int kC = W / 8;  // chunks per row
  static_assert(kC == 2 || kC == 4 || kC % 8 == 0, "row width");
  int f;
  if constexpr (kC >= 8)
    f = row & 7;
  else if constexpr (kC == 4)
    f = (row >> 1) & 3;
  else
    f = (row >> 2) & 1;
  return row * W + ((((col >> 3) ^ f)) << 3) + (col & 7);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  // src-size 0 copies nothing and fills the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Rows row0 .. row0 + R - 1 of a strided view (row stride ss, W elements
// a row) into the swizzled tile dst; rows at or past S are zero. With
// `vec` (16-byte aligned rows) by cp.async, to be waited for with the
// group it is committed in; else by plain loads, complete on return.
template <typename T, int W, int R, int NT>
__device__ __forceinline__ void load_rows(T* dst, const T* src, int64_t ss,
                                          int row0, int S, bool vec) {
  constexpr int kC = W / 8;
  if (vec) {
#pragma unroll
    for (int idx = threadIdx.x; idx < R * kC; idx += NT) {
      const int r = idx / kC, c = (idx % kC) * 8;
      const int s = row0 + r;
      // a row past S is not read; its address only has to be valid
      const T* p = src + (int64_t)(s < S ? s : 0) * ss + c;
      cp_async16(dst + swz<W>(r, c), p, s < S);
    }
  } else {
    for (int idx = threadIdx.x; idx < R * W; idx += NT) {
      const int r = idx / W, c = idx % W;
      const int s = row0 + r;
      dst[swz<W>(r, c)] = s < S ? src[(int64_t)s * ss + c] : from_f32<T>(0.f);
    }
  }
}

// Writes rows row0 .. row0 + R - 1 (those below S) of the swizzled tile
// src to a strided view: 16 bytes a thread with `vec`, else one element.
template <typename T, int W, int R>
__device__ __forceinline__ void store_rows(T* dst, int64_t ss, const T* src,
                                           int row0, int S, bool vec,
                                           int tid, int nthreads) {
  constexpr int kC = W / 8;
  if (vec) {
    for (int idx = tid; idx < R * kC; idx += nthreads) {
      const int r = idx / kC, c = (idx % kC) * 8;
      if (row0 + r < S)
        *reinterpret_cast<uint4*>(dst + (int64_t)(row0 + r) * ss + c) =
            *reinterpret_cast<const uint4*>(src + swz<W>(r, c));
    }
  } else {
    for (int idx = tid; idx < R * W; idx += nthreads) {
      const int r = idx / W, c = idx % W;
      if (row0 + r < S) dst[(int64_t)(row0 + r) * ss + c] = src[swz<W>(r, c)];
    }
  }
}

// ldmatrix: four (x4) or two (x2) 8 x 8 matrices of 16-bit elements. Lane
// l gives the address of row l % 8 of matrix l / 8 and receives, in
// register i, elements (l / 4, 2 (l % 4) .. +1) of matrix i, or with
// .trans elements (2 (l % 4) .. +1, l / 4).
__device__ __forceinline__ void ldsm_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

// c (16 x 8, f32) += a (16 x 16) * b (16 x 8). Fragments as in the PTX
// ISA: with g = lane / 4 and t = lane % 4, c holds (g, 2t .. +1) and
// (g + 8, 2t .. +1); a holds (g, 2t), (g + 8, 2t), (g, 2t + 8),
// (g + 8, 2t + 8), two elements each; b holds (k 2t .. +1, n g) and
// (k 2t + 8 .. +9, n g).
template <typename T>
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

// wgmma (sm_90a): a warpgroup of four warps computes a 64 x 64 f32 tile,
// warp w of the group owning rows 16w .. 16w + 15 in the mma.sync
// accumulator layout: acc[n][e] is column block n, elements as c of
// mma16816. Operands in shared memory are described by descriptors of
// tiles whose rows are 128 bytes (64 16-bit elements), swizzled as swz<64>
// with the tile starting on a 1024-byte boundary: the hardware's 128-byte
// swizzle. Each of the four steps of one call multiplies 16 of the
// contraction dimension; the call waits for its products.

// Descriptor of a 128-byte-swizzled tile at shared address `addr`: 8-row
// groups 1024 bytes apart (given as both strides: which of the two the
// layout reads depends on its major-ness, the other is unused here).
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

#define MXT_WG_ACC                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"
#define MXT_WG_OPS(x)                                                       \
  "+f"(x[0][0]), "+f"(x[0][1]), "+f"(x[0][2]), "+f"(x[0][3]),               \
      "+f"(x[1][0]), "+f"(x[1][1]), "+f"(x[1][2]), "+f"(x[1][3]),           \
      "+f"(x[2][0]), "+f"(x[2][1]), "+f"(x[2][2]), "+f"(x[2][3]),           \
      "+f"(x[3][0]), "+f"(x[3][1]), "+f"(x[3][2]), "+f"(x[3][3]),           \
      "+f"(x[4][0]), "+f"(x[4][1]), "+f"(x[4][2]), "+f"(x[4][3]),           \
      "+f"(x[5][0]), "+f"(x[5][1]), "+f"(x[5][2]), "+f"(x[5][3]),           \
      "+f"(x[6][0]), "+f"(x[6][1]), "+f"(x[6][2]), "+f"(x[6][3]),           \
      "+f"(x[7][0]), "+f"(x[7][1]), "+f"(x[7][2]), "+f"(x[7][3])
// acc += A B over 64 of the contraction dimension, A and B in shared
// memory at addresses a and b. K-major operands (kT 0: A as rows of M, B
// stored as B^T, rows of N) step 32 bytes along a row; N- or M-major ones
// (kT 1, read through the transpose bit: row k holds A[.][k] or B[k][.])
// step 16 rows, 2048 bytes.
#define MXT_WG_SS(TY)                                                        \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %40, 0;\n"                           \
      "wgmma.fence.sync.aligned;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " MXT_WG_ACC \
      ", %32, %36, p, 1, 1, %41, %42;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " MXT_WG_ACC \
      ", %33, %37, p, 1, 1, %41, %42;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " MXT_WG_ACC \
      ", %34, %38, p, 1, 1, %41, %42;\n"                                     \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " MXT_WG_ACC \
      ", %35, %39, p, 1, 1, %41, %42;\n"                                     \
      "wgmma.commit_group.sync.aligned;\n"                                   \
      "wgmma.wait_group.sync.aligned 0;\n}\n"                                \
      : MXT_WG_OPS(acc)                                                      \
      : "l"(wg_desc(a)), "l"(wg_desc(a + kSA)), "l"(wg_desc(a + 2 * kSA)),  \
        "l"(wg_desc(a + 3 * kSA)), "l"(wg_desc(b)), "l"(wg_desc(b + kSB)),   \
        "l"(wg_desc(b + 2 * kSB)), "l"(wg_desc(b + 3 * kSB)), "r"(1),        \
        "n"(kTA), "n"(kTB))
template <typename T, int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss(float (&acc)[8][4], uint32_t a,
                                         uint32_t b) {
  constexpr uint32_t kSA = kTA ? 2048 : 32, kSB = kTB ? 2048 : 32;
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    MXT_WG_SS("bf16");
  else
    MXT_WG_SS("f16");
}
// acc += A B over 64 of the contraction dimension, A (64 x 64) in
// registers as four mma16816 A fragments per warp (one per 16 of the
// contraction), B (64 x 64, N-major: row k holds B[k][0..63]) in shared
// memory at `b`, read through the transpose bit.
#define MXT_WG_RS(TY)                                                        \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %52, 0;\n"                           \
      "wgmma.fence.sync.aligned;\n"                                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " MXT_WG_ACC \
      ", {%32, %33, %34, %35}, %48, p, 1, 1, 1;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " MXT_WG_ACC \
      ", {%36, %37, %38, %39}, %49, p, 1, 1, 1;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " MXT_WG_ACC \
      ", {%40, %41, %42, %43}, %50, p, 1, 1, 1;\n"                          \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " MXT_WG_ACC \
      ", {%44, %45, %46, %47}, %51, p, 1, 1, 1;\n"                          \
      "wgmma.commit_group.sync.aligned;\n"                                   \
      "wgmma.wait_group.sync.aligned 0;\n}\n"                                \
      : MXT_WG_OPS(acc)                                                      \
      : "r"(a[0][0]), "r"(a[0][1]), "r"(a[0][2]), "r"(a[0][3]),              \
        "r"(a[1][0]), "r"(a[1][1]), "r"(a[1][2]), "r"(a[1][3]),              \
        "r"(a[2][0]), "r"(a[2][1]), "r"(a[2][2]), "r"(a[2][3]),              \
        "r"(a[3][0]), "r"(a[3][1]), "r"(a[3][2]), "r"(a[3][3]),              \
        "l"(wg_desc(b)), "l"(wg_desc(b + 2048)), "l"(wg_desc(b + 4096)),     \
        "l"(wg_desc(b + 6144)), "r"(1))
template <typename T>
__device__ __forceinline__ void wgmma_rs(float (&acc)[8][4],
                                         const uint32_t (&a)[4][4],
                                         uint32_t b) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    MXT_WG_RS("bf16");
  else
    MXT_WG_RS("f16");
}

// Makes this thread's generic-proxy writes to shared memory (plain stores
// and completed cp.async copies) visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 2^x on the special-function unit (relative error about 2^-22, results
// below 2^-126 flushed to 0): the softmax exponentials of the 16-bit
// kernels, whose P is then rounded to 8 or 11 bits.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// p[0] += x and p[1] += y in one vector reduction (p 8-byte aligned).
__device__ __forceinline__ void red_add2(float* p, float x, float y) {
  asm volatile("red.global.add.v2.f32 [%0], {%1, %2};\n" ::"l"(p), "f"(x),
               "f"(y)
               : "memory");
}

// Two f32 values rounded to T and packed: x in the low half (the smaller
// column of an mma fragment).
template <typename T>
__device__ __forceinline__ uint32_t pack2(float x, float y) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// Sets the dynamic shared-memory limit of kernel `fn` and checks that a
// (n, B*H) grid fits. Returns the first error.
template <typename Fn>
cudaError_t prepare(Fn fn, size_t bytes, int B, int H) {
  if ((int64_t)B * H > 65535) return cudaErrorInvalidConfiguration;
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline View view(const long long* s) { return View{s[0], s[1], s[2]}; }

// Whether every row of view `v` at `p` starts on a 16-byte boundary, so
// that tiles may move 16 bytes at a time.
inline bool vec_ok(const void* p, View v, int elem_bytes) {
  const int64_t per = 16 / elem_bytes;
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && v.sb % per == 0 &&
         v.sh % per == 0 && v.ss % per == 0;
}

}  // namespace mxt_flash
