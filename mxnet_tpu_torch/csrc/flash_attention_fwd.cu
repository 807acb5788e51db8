// Flash-attention forward for Hopper (sm_90a): a plain C launcher and its
// CPython entry point (pyentry.cuh), built and imported by
// mxnet_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas kernel _fwd_kernel of
// mxnet_tpu/ops/flash_attention.py:143 (launched by _fwd_pallas, :191; the
// math is _fwd_core, :80). Same function: out = softmax(Q K^T * scale) V
// and lse = logsumexp(Q K^T * scale) per row, with an online softmax whose
// statistics are f32 and in the log2 domain (exp2), so the S x S score
// matrix never reaches device memory. The causal mask takes a row offset:
// column c is visible to row r when r + offset >= c. K tiles that no row
// of the Q tile sees are never visited; only tiles that hide or cut off
// some pair pay for the mask test. A row that sees no column gets out 0
// and lse -1e30 (the reference's :133-139).
//
// What bounds it: operations. At the model's shapes (B 4, H 12, S 2048,
// D 64, causal) the visible pairs are 48 * 2048 * 2049 / 2 = 1.007e8, so
// 4 * D * pairs = 25.8 GFLOP against 50.7 MB of HBM traffic in bf16: 26 us
// at the tensor cores' 989 TFLOP/s, 15 us at 3.35 TB/s.
//
// bf16/f16 design (flash_fwd_mma_kernel; FlashAttention-2's shape, with
// Hopper's warpgroup products at D 64):
//   - one block of 8 warps per (128-row Q tile, batch*head), scheduled
//     heaviest first across all heads (the last Q tiles of a causal head
//     see the most K tiles); each warp owns 16 query rows, each warpgroup
//     of four warps 64;
//   - Q is copied once; K/V tiles of kFwdBN = 64 keys pass through a
//     two-stage cp.async ring: the next tile's copy is in flight while the
//     current one is multiplied;
//   - D 64: S = Q K^T is one wgmma call per warpgroup (m64n64k16 x 4, Q and
//     K both K-major in 128-byte-swizzled tiles, no transpose needed);
//     O += P V another (P from registers, V through the transpose bit).
//     Other D: mma.sync m16n8k16 with ldmatrix, Q's fragments in registers
//     (D <= 32) or re-read per step (D 128 and 256, for registers);
//   - head dims between the built ones run at the next built D (16, 32,
//     64, 128, 256) with the columns past the true d zero (flash_common.cuh):
//     D 256 keeps the same shape, a warp's 16 rows of O taking 128 f32
//     registers a thread, so one block of 8 warps fills an SM's registers
//     (nvcc -Xptxas -v: at the 255-register limit, with a small spill)
//     and 193 KB of shared memory (Q 64 KB, two stages of K and V
//     128 KB). Simple and correct first; splitting O's columns across
//     two warps would free the registers;
//   - the scores stay in the f32 accumulators: the row max and sum are
//     reduced over the four threads of a row with two shuffles, the row
//     sum a per-thread partial until the end; O is rescaled in registers;
//     P is rounded to the input type in registers (as the reference casts
//     p to v's dtype) and is the A operand of O += P V; exponentials by
//     ex2.approx;
//   - a warp (warpgroup, for wgmma) whose rows see nothing of a tile skips
//     it;
//   - the epilogue normalises O in registers, stages it through the warp's
//     own rows of the Q tile and writes 16-byte rows into the (B, S, H, D)
//     output; lse is written as f32;
//   - q/k/v and out are read and written through element strides with a
//     contiguous last dimension (the model's q/k/v are transposed views of
//     its fused QKV projection, no copy); rows that are not 16-byte
//     aligned are loaded and stored one element at a time in the same
//     kernel.
// What this does about the first kernel's limits: no score, probability or
// partial product goes through shared memory (it wrote and read back about
// 80 KB of f32 scratch per K tile behind four barriers); the products are
// wgmma or mma.sync reading swizzled tiles instead of WMMA fragments
// reloaded from padded ones; copies overlap the products inside a block.
// Measured alternatives (mxnet_tpu_torch/tools/flash_variants.py): mma.sync at D 64, K/V
// tiles of 128 keys, a three-stage ring with one barrier a tile.
//
// FFMA design (flash_fwd_ffma_kernel: f32 at every head dim, in true fp32
// as the reference's HIGHEST precision, no TF32; bf16/f16 above D 256,
// converted to f32 as they are loaded). In f32 the 67 TFLOP/s of FFMA
// bound it at 385 us at the model's shapes. The first f32 kernel gave each
// output element to one thread, which made two shared-memory loads per FMA
// and was bound by shared memory; this one is an SGEMM micro-kernel
// (flash_common.cuh):
//   - one block of 256 threads per (Q tile, batch*head, output slab), 2
//     blocks an SM; a thread owns rows ty + 16 i of S, O and the softmax
//     statistics, keys tx + 16 j (j < 4) of S and 4 (8) columns of O, so
//     the softmax runs on registers (row max by shuffles within a
//     half-warp, the row sum a per-thread partial until the end) and O is
//     rescaled in place. To D 64 (the model's) a Q tile is 128 rows, 8 a
//     thread (110 KB of shared memory; nvcc -Xptxas -v: 128 registers,
//     144 B of spills in f32), so that each 16-byte read of a K or V row
//     feeds twice the FFMA of 64-row tiles: 8 shared-memory wavefronts per
//     64 FFMA instead of 12. Wider heads take 64-row tiles, 4 rows a
//     thread (88 KB), for O's registers;
//   - the head dim is a run-time argument: S = Q K^T loops over it in
//     chunks of 32 columns (Q and K chunks, zero past d, through a
//     two-stage cp.async ring), so one build takes every d; O's columns
//     form slabs of 64 (d <= 64) or 128 on the grid's z dimension, each
//     recomputing S (none at the model's D 64);
//   - per K tile: the chunks of S, the softmax, P (rounded to the input
//     type) to shared memory, O += P V for the slab; each step's tiles are
//     copied while the step before it computes;
//   - the epilogue divides by the row sum; the first slab writes lse.
// Measured alternatives (tools/flash_variants.py --dtype float32): 64-row
// tiles with S in one 64-column chunk or in two of 32.

#include "pyentry.cuh"

#include "flash_common.cuh"

namespace {

using namespace mxt_flash;

// ---------------------------------------------------------------------------
// bf16/f16: tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kFwdBM = 128;  // query rows per block, 16 per warp
constexpr int kFwdBN = 64;   // keys per K/V tile

template <int D>
struct FwdLayout {
  // D 64 (rows of 128 bytes, the hardware's swizzle): warpgroup products
  static constexpr bool kWgmma = D == 64 && kFwdBN == 64;
  static constexpr bool kQInRegs = D <= 64 && !kWgmma;
  // two blocks an SM (128 registers a thread) where the accumulators fit
  static constexpr int kMinBlocks = D <= 64 ? 2 : 1;
  static constexpr size_t kQ = (size_t)kFwdBM * D * 2;   // bytes
  static constexpr size_t kKV = (size_t)kFwdBN * D * 2;  // one K or V tile
  // Q + 2 stages of K, V, and room to start Q on a 1024-byte boundary
  static constexpr size_t kBytes = kQ + 4 * kKV + 1024;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, FwdLayout<D>::kMinBlocks)
flash_fwd_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ out,
                     float* __restrict__ lse, int H, int S, int d, View vq,
                     View vk, View vv, View vo, int causal, int offset,
                     float scale, bool vec) {
  using L = FwdLayout<D>;
  constexpr int BN = kFwdBN;
  extern __shared__ __align__(128) unsigned char smem[];
  unsigned char* base = smem + ((1024 - (smem_u32(smem) & 1023)) & 1023);
  T* sq = reinterpret_cast<T*>(base);
  T* skv = reinterpret_cast<T*>(base + L::kQ);  // stage s: K, then V

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBM;  // heaviest first
  const T* qb = q + b * vq.sb + h * vq.sh;
  const T* kb = k + b * vk.sb + h * vk.sh;
  const T* vb = v + b * vv.sb + h * vv.sh;
  T* ob = out + b * vo.sb + h * vo.sh;

  const int nk = (S + BN - 1) / BN;
  int nk_run = nk;
  if (causal) {
    // the largest column any row of this tile sees
    const int last_col = min(q0 + kFwdBM, S) - 1 + offset;
    nk_run = last_col < 0 ? 0 : min(nk, last_col / BN + 1);
  }
  if (nk_run > 0) {
    load_rows<T, D, kFwdBM, kThreads>(sq, qb, vq.ss, q0, S, d, vec);
    load_rows<T, D, BN, kThreads>(skv, kb, vk.ss, 0, S, d, vec);
    load_rows<T, D, BN, kThreads>(skv + BN * D, vb, vv.ss, 0, S, d, vec);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix matrix and row
  const int wq = warp * 16;                 // the warp's rows in the tile
  const int row0 = q0 + wq + g, row1 = row0 + 8;
  const float c = scale * kLog2e;  // raw score -> log2 domain

  uint32_t qf[L::kQInRegs ? D / 16 : 1][4];
  float o[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int j = 0; j < nk_run; ++j) {
    if (j + 1 < nk_run) {
      T* nxt = skv + ((j + 1) & 1) * 2 * BN * D;
      load_rows<T, D, BN, kThreads>(nxt, kb, vk.ss, (j + 1) * BN, S, d, vec);
      load_rows<T, D, BN, kThreads>(nxt + BN * D, vb, vv.ss, (j + 1) * BN, S,
                                    d, vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    if constexpr (L::kWgmma) fence_proxy_async();
    __syncthreads();
    if constexpr (L::kQInRegs) {
      if (j == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          ldsm_x4(qf[kk], sq + swz<D>(wq + mr + (mi & 1) * 8,
                                      kk * 16 + (mi >> 1) * 8));
      }
    }
    const int k0 = j * BN;
    const T* sk = skv + (j & 1) * 2 * BN * D;
    const T* sv = sk + BN * D;
    // a warp (warpgroup, for wgmma) whose rows see nothing of this tile
    // skips it
    const int last_row = L::kWgmma ? q0 + (wq & ~63) + 63 : q0 + wq + 15;
    if (!(causal && k0 > last_row + offset)) {
      float s[BN / 8][4];
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
      if constexpr (L::kWgmma)
        wgmma_ss<T, 0, 0>(s, smem_u32(sq + (wq & ~63) * D), smem_u32(sk));
#pragma unroll
      for (int kk = 0; kk < (L::kWgmma ? 0 : D / 16); ++kk) {
        uint32_t a[4];
        if constexpr (L::kQInRegs) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldsm_x4(a, sq + swz<D>(wq + mr + (mi & 1) * 8,
                                 kk * 16 + (mi >> 1) * 8));
        }
#pragma unroll
        for (int nn = 0; nn < BN / 16; ++nn) {
          uint32_t bk[4];
          ldsm_x4(bk, sk + swz<D>(nn * 16 + mr + (mi >> 1) * 8,
                                  kk * 16 + (mi & 1) * 8));
          mma16816<T>(s[2 * nn], a, bk[0], bk[1]);
          mma16816<T>(s[2 * nn + 1], a, bk[2], bk[3]);
        }
      }
      // the mask only where some pair of the warp's rows is hidden or cut
      const bool masked = (causal && k0 + BN - 1 > q0 + wq + offset) ||
                          k0 + BN > S || q0 + wq + 16 > S;
      float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float t = s[n][e] * c;
          if (masked) {
            const int row = e < 2 ? row0 : row1;
            const int col = k0 + n * 8 + 2 * tq + (e & 1);
            if (col >= S || row >= S || (causal && row + offset < col))
              t = kNegInf;
          }
          s[n][e] = t;
        }
        mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
        mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float alpha0 = fast_exp2(m0 - mn0), alpha1 = fast_exp2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < BN / 8; ++n) {
        // a hidden pair contributes exactly 0, also while the row has seen
        // nothing yet (its max still -1e30)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float mrow = e < 2 ? mn0 : mn1;
          s[n][e] = s[n][e] > 0.5f * kNegInf ? fast_exp2(s[n][e] - mrow) : 0.f;
        }
        sum0 += s[n][0] + s[n][1];
        sum1 += s[n][2] + s[n][3];
      }
      l0 = l0 * alpha0 + sum0;
      l1 = l1 * alpha1 + sum1;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        o[n][0] *= alpha0;
        o[n][1] *= alpha0;
        o[n][2] *= alpha1;
        o[n][3] *= alpha1;
      }
      // O += P V: two 16 x 8 score tiles are one 16 x 16 A fragment
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        pa[kk][0] = pack2<T>(s[2 * kk][0], s[2 * kk][1]);
        pa[kk][1] = pack2<T>(s[2 * kk][2], s[2 * kk][3]);
        pa[kk][2] = pack2<T>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
        pa[kk][3] = pack2<T>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      }
      if constexpr (L::kWgmma) wgmma_rs<T>(o, pa, smem_u32(sv));
#pragma unroll
      for (int kk = 0; kk < (L::kWgmma ? 0 : BN / 16); ++kk) {
        const uint32_t* a = pa[kk];
#pragma unroll
        for (int dd = 0; dd < D / 16; ++dd) {
          uint32_t bv[4];
          ldsm_x4_t(bv, sv + swz<D>(kk * 16 + mr + (mi & 1) * 8,
                                    dd * 16 + (mi >> 1) * 8));
          mma16816<T>(o[2 * dd], a, bv[0], bv[1]);
          mma16816<T>(o[2 * dd + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // before the next copy overwrites this stage
  }
  cp_async_wait<0>();
  __syncthreads();

  // epilogue: the full row sums, then out and lse from registers
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // a row with no visible column has l == 0: out 0, never NaN
  const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f;
  const float inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
  T* so = sq + wq * D;  // the warp's own 16 rows of the Q tile
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int col = n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(so + swz<D>(g, col)) =
        pack2<T>(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(so + swz<D>(g + 8, col)) =
        pack2<T>(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
  store_rows<T, D, 16>(ob, vo.ss, so, q0 + wq, S, d, vec, lane, 32);
  if (tq == 0) {
    if (row0 < S)
      lse[(int64_t)bh * S + row0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kNegInf;
    if (row1 < S)
      lse[(int64_t)bh * S + row1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// FFMA kernel: f32 at every head dim, bf16/f16 above 256
// ---------------------------------------------------------------------------

// One block of 256 threads per (16 MI-row Q tile, batch*head, output slab
// of 64 NH columns), Q tiles heaviest first. Per K tile of 64 keys:
// S = Q K^T over the head dim in chunks of DK columns (Q and K chunks
// through a two-stage ring), the online softmax on S in registers, P to
// shared memory, O += P V for the slab (V through its own buffer). Every
// step's tiles are copied while the step before it computes.
template <typename T, int MI, int NH, int DK>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_ffma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ out,
                      float* __restrict__ lse, int H, int S, int d, View vq,
                      View vk, View vv, View vo, int causal, int offset,
                      float scale, bool vec) {
  constexpr int BM = 16 * MI, BN = kFfmaBN;
  constexpr int SW = 64 * NH;  // slab width
  constexpr int LDC = DK + 4;  // Q/K chunk rows: 4 words apart mod 32 banks
  constexpr int LDP = BN + 16;  // P rows: a warp's two rows on other banks
  static_assert(BN == 64, "the 16 x 16 thread grid's 4 keys a thread");
  extern __shared__ __align__(16) float fsm[];
  float* ring = fsm;                       // stage s: Q chunk, then K chunk
  float* sv = ring + 2 * (BM + BN) * LDC;  // V: BN x SW
  float* sp = sv + BN * SW;                // P: BM x LDP

  const int bh = blockIdx.x, b = bh / H, h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int c0 = blockIdx.z * SW;                    // the slab's first column
  const T* qb = q + b * vq.sb + h * vq.sh;
  const T* kb = k + b * vk.sb + h * vk.sh;
  const T* vb = v + b * vv.sb + h * vv.sh;
  T* ob = out + b * vo.sb + h * vo.sh;

  const int nk = (S + BN - 1) / BN;
  int nk_run = nk;
  if (causal) {
    // the largest column any row of this tile sees
    const int last_col = min(q0 + BM, S) - 1 + offset;
    nk_run = last_col < 0 ? 0 : min(nk, last_col / BN + 1);
  }
  const int nc = (d + DK - 1) / DK;  // chunks of S
  const int per = nc + 1;            // steps a K tile: the chunks, then P V
  const int steps = nk_run * per;

  // copies step t's tiles: a Q and a K chunk into ring stage (chunk count)
  // % 2, or the slab of V
  auto issue = [&](int t) {
    const int j = t / per, c = t % per;
    if (c < nc) {
      float* st = ring + ((j * nc + c) & 1) * (BM + BN) * LDC;
      load_f32_tile<T, BM, DK>(st, LDC, qb, vq.ss, q0, S, c * DK, d, vec);
      load_f32_tile<T, BN, DK>(st + BM * LDC, LDC, kb, vk.ss, j * BN, S,
                               c * DK, d, vec);
    } else {
      load_f32_tile<T, BN, SW>(sv, SW, vb, vv.ss, j * BN, S, c0, d, vec);
    }
  };

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float cl = scale * kLog2e;  // raw score -> log2 domain
  // rows ty + 16 i of S, O, m and l; keys tx + 16 j of S; columns
  // c0 + 64 hh + 4 tx .. + 3 of O
  float s[MI][4], o[MI][4 * NH], m[MI], l[MI];
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4 * NH; ++e) o[i][e] = 0.f;
  }

  if (steps > 0) issue(0);
  cp_async_commit();
  for (int t = 0; t < steps; ++t) {
    if (t + 1 < steps) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int j = t / per, c = t % per, k0 = j * BN;
    if (c < nc) {
      // S += Q K^T over this chunk: the thread's four keys' float4 first,
      // then one row's at a time
      const float* sq = ring + ((j * nc + c) & 1) * (BM + BN) * LDC;
      const float* qa = sq + ty * LDC;
      const float* ka = sq + BM * LDC + tx * LDC;
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < MI; ++i)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) s[i][jj] = 0.f;
      }
#pragma unroll
      for (int kk = 0; kk < DK; kk += 4) {
        float4 bk[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          bk[jj] = *reinterpret_cast<const float4*>(ka + 16 * jj * LDC + kk);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float4 a =
              *reinterpret_cast<const float4*>(qa + 16 * i * LDC + kk);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            s[i][jj] = fmaf(a.x, bk[jj].x, s[i][jj]);
            s[i][jj] = fmaf(a.y, bk[jj].y, s[i][jj]);
            s[i][jj] = fmaf(a.z, bk[jj].z, s[i][jj]);
            s[i][jj] = fmaf(a.w, bk[jj].w, s[i][jj]);
          }
        }
      }
      if (c == nc - 1) {
        // the online softmax; the mask only where some pair of the tile is
        // hidden or ragged
        const bool masked = (causal && k0 + BN - 1 > q0 + offset) ||
                            k0 + BN > S || q0 + BM > S;
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const int row = q0 + ty + 16 * i;
          float mx = kNegInf;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int col = k0 + tx + 16 * jj;
            float x = s[i][jj] * cl;
            if (masked &&
                (col >= S || row >= S || (causal && row + offset < col)))
              x = kNegInf;
            s[i][jj] = x;
            mx = fmaxf(mx, x);
          }
          // the 16 threads of a row are one half-warp
#pragma unroll
          for (int w = 8; w > 0; w >>= 1)
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
          const float mn = fmaxf(m[i], mx);
          const float alpha = exp2f(m[i] - mn);
          m[i] = mn;
          float sum = 0.f;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            // a hidden pair contributes exactly 0, also while the row has
            // seen nothing yet (its max still -1e30)
            const float p =
                s[i][jj] > 0.5f * kNegInf ? exp2f(s[i][jj] - mn) : 0.f;
            sum += p;
            // P rounded to the input type, as the reference casts p to v's
            sp[(ty + 16 * i) * LDP + tx + 16 * jj] = round_to<T>(p);
          }
          l[i] = l[i] * alpha + sum;  // this thread's part of the row sum
#pragma unroll
          for (int e = 0; e < 4 * NH; ++e) o[i][e] *= alpha;
        }
      }
    } else {
      // O += P V for the slab: four keys' V float4 first, then one row's P
      const float* pa = sp + ty * LDP;
#pragma unroll 2
      for (int kk = 0; kk < BN; kk += 4) {
        float4 vr[4][NH];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int hh = 0; hh < NH; ++hh)
            vr[e][hh] = *reinterpret_cast<const float4*>(
                sv + (kk + e) * SW + 64 * hh + 4 * tx);
#pragma unroll
        for (int i = 0; i < MI; ++i) {
          const float4 pr =
              *reinterpret_cast<const float4*>(pa + 16 * i * LDP + kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pe = comp(pr, e);
#pragma unroll
            for (int hh = 0; hh < NH; ++hh) {
              o[i][4 * hh] = fmaf(pe, vr[e][hh].x, o[i][4 * hh]);
              o[i][4 * hh + 1] = fmaf(pe, vr[e][hh].y, o[i][4 * hh + 1]);
              o[i][4 * hh + 2] = fmaf(pe, vr[e][hh].z, o[i][4 * hh + 2]);
              o[i][4 * hh + 3] = fmaf(pe, vr[e][hh].w, o[i][4 * hh + 3]);
            }
          }
        }
      }
    }
    __syncthreads();  // before the next copies overwrite what was read
  }
  cp_async_wait<0>();

  // epilogue: the full row sums, then out (and lse, from the first slab)
#pragma unroll
  for (int i = 0; i < MI; ++i) {
    float li = l[i];
#pragma unroll
    for (int w = 8; w > 0; w >>= 1)
      li += __shfl_xor_sync(0xffffffffu, li, w);
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    // a row with no visible column has l == 0: out 0, never NaN
    const float inv = li > 0.f ? 1.f / li : 0.f;
#pragma unroll
    for (int hh = 0; hh < NH; ++hh) {
      const int col = c0 + 64 * hh + 4 * tx;
      if (col < d)
        store4<T>(ob + (int64_t)row * vo.ss + col,
                  make_float4(o[i][4 * hh] * inv, o[i][4 * hh + 1] * inv,
                              o[i][4 * hh + 2] * inv, o[i][4 * hh + 3] * inv),
                  d - col, vec);
    }
    if (blockIdx.z == 0 && tx == 0)
      lse[(int64_t)bh * S + row] =
          li > 0.f ? m[i] * kLn2 + logf(li) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int B, H, S, d;
  const long long* st;
  int causal, offset;
  float scale;
};

// The FFMA kernel on Q tiles of 16 MI rows and slabs of 64 NH columns, S
// in chunks of DK.
template <typename T, int MI, int NH, int DK>
cudaError_t launch_ffma_slabs(const Args& a, cudaStream_t stream) {
  auto fn = flash_fwd_ffma_kernel<T, MI, NH, DK>;
  constexpr int kBM = 16 * MI, kSW = 64 * NH;
  const size_t bytes =
      sizeof(float) * (2 * (kBM + kFfmaBN) * (DK + 4) + kFfmaBN * kSW +
                       kBM * (kFfmaBN + 16));
  const int tiles = (a.S + kBM - 1) / kBM;
  const int slabs = (a.d + kSW - 1) / kSW;
  if (tiles > 65535 || slabs > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const View vq = view(a.st), vk = view(a.st + 3), vv = view(a.st + 6),
             vo = view(a.st + 9);
  const int eb = sizeof(T);
  const bool vec = vec_ok(a.q, vq, eb) && vec_ok(a.k, vk, eb) &&
                   vec_ok(a.v, vv, eb) && vec_ok(a.out, vo, eb);
  const dim3 grid(a.B * a.H, tiles, slabs);
  fn<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.H, a.S,
      a.d, vq, vk, vv, vo, a.causal, a.offset, a.scale, vec);
  return cudaGetLastError();
}

// Head dims to 64: Q tiles of kFfmaFwdBM rows (8 a thread), one slab of 64
// columns, S in chunks of kFfmaFwdChunk (110 KB of shared memory). Wider
// ones: Q tiles of kFfmaBM rows (4 a thread, for registers), slabs of
// kFfmaFwdSlab each recomputing S (88 KB).
template <typename T>
cudaError_t launch_ffma(const Args& a, cudaStream_t stream) {
  static_assert(kFfmaFwdSlab == 128, "slabs of one or two 64-column halves");
  if (a.d <= 64)
    return launch_ffma_slabs<T, kFfmaFwdBM / 16, 1, kFfmaFwdChunk>(a, stream);
  return launch_ffma_slabs<T, kFfmaBM / 16, 2, kFfmaFwdChunk>(a, stream);
}

template <typename T, int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  using L = FwdLayout<D>;
  auto fn = flash_fwd_mma_kernel<T, D>;
  cudaError_t err = prepare(fn, L::kBytes, a.B, a.H);
  if (err != cudaSuccess) return err;
  const View vq = view(a.st), vk = view(a.st + 3), vv = view(a.st + 6),
             vo = view(a.st + 9);
  const bool vec = vec_ok(a.q, vq, 2) && vec_ok(a.k, vk, 2) &&
                   vec_ok(a.v, vv, 2) && vec_ok(a.out, vo, 2);
  const dim3 grid(a.B * a.H, (a.S + kFwdBM - 1) / kFwdBM);
  fn<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.H, a.S,
      a.d, vq, vk, vv, vo, a.causal, a.offset, a.scale, vec);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch(int dtype, const Args& a, cudaStream_t stream) {
  switch (dtype) {
    case 1:
      return launch_mma<__nv_bfloat16, D>(a, stream);
    case 2:
      return launch_mma<__half, D>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and out share
// it). strides: 12 element strides, (b, h, s) of q, k, v and out, each
// with a contiguous last dimension. lse: contiguous (B, H, S) float32.
// D is the head dim, any D >= 1: f32, and bf16/f16 above 256, run the FFMA
// kernel; bf16/f16 to 256 the tensor-core kernels built for the next of
// 16, 32, 64, 128 and 256. Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int dtype, int B, int H, int S, int D,
                                   const long long* strides, int causal,
                                   int offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, lse, B, H, S, D, strides, causal, offset, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ffma_route(dtype, D)) {
    switch (dtype) {
      case 0:
        return (int)launch_ffma<float>(a, st);
      case 1:
        return (int)launch_ffma<__nv_bfloat16>(a, st);
      default:
        return (int)launch_ffma<__half>(a, st);
    }
  }
  switch (padded_dim(D)) {
    case 16:
      return (int)launch<16>(dtype, a, st);
    case 32:
      return (int)launch<32>(dtype, a, st);
    case 64:
      return (int)launch<64>(dtype, a, st);
    case 128:
      return (int)launch<128>(dtype, a, st);
    case 256:
      return (int)launch<256>(dtype, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

namespace {

PyObject* py_launch(PyObject*, PyObject* const* a, Py_ssize_t n) {
  using namespace mxt_py;
  if (!nargs(n, 15, "flash_attention_fwd")) return nullptr;
  const void *q = ptr(a[0]), *k = ptr(a[1]), *v = ptr(a[2]);
  void* out = ptr(a[3]);
  float* lse = static_cast<float*>(ptr(a[4]));
  const int dtype = i32(a[5]), B = i32(a[6]), H = i32(a[7]), S = i32(a[8]),
            D = i32(a[9]);
  long long strides[12];
  if (!i64s(a[10], strides, 12)) return nullptr;
  const int causal = i32(a[11]), offset = i32(a[12]);
  const float scale = f32(a[13]);
  void* stream = ptr(a[14]);
  if (PyErr_Occurred()) return nullptr;
  int err;
  Py_BEGIN_ALLOW_THREADS
  err = flash_attention_fwd(q, k, v, out, lse, dtype, B, H, S, D, strides,
                            causal, offset, scale, stream);
  Py_END_ALLOW_THREADS
  return PyLong_FromLong(err);
}

}  // namespace

MXT_PY_MODULE(flash_attention_fwd, py_launch)
