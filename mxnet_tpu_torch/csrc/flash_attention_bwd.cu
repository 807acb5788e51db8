// Flash-attention backward for Hopper (sm_90a), plain C entry point bound
// with ctypes by mxnet_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas kernel _bwd_kernel of
// mxnet_tpu/ops/flash_attention.py:298 (launched by _bwd_pallas, :324; the
// math is _bwd_core, :230). Same function: given q, k, v, out, dO, the
// forward's lse and the cotangent of lse, with dl = rowsum(dO * out) - dlse
// (the reference's delta - dlse, :333-334), it recomputes
// P = exp(Q K^T * scale - lse) and forms
//   dV = P^T dO,   dS = P * (dO V^T - dl) * scale,   dK = dS^T Q,
//   dQ = dS K.
// P and dS are rounded to the input type before their products, as the
// reference casts them. Tiles that need the mask clamp the exponent at 0
// and zero the rows whose lse is -1e30 (rows that see nothing, :268-277):
// without that, exp2 of (-1e30 - -1e30)-sized terms would give inf and
// NaN gradients for negative offsets.
//
// What bounds it: operations. At the model's shapes (B 4, H 12, S 2048,
// D 64, causal, 1.007e8 visible pairs) the minimal work is
// 10 * D * pairs = 64.5 GFLOP, 65 us at 989 TFLOP/s in bf16, against
// about 101 MB of HBM traffic (30 us at 3.35 TB/s).
//
// bf16/f16 design: one pass, five tile products, three kernels launched
// from the one entry point:
//   1. flash_bwd_preprocess_kernel: dl = rowsum(dO * out) - dlse per row
//      (f32) and zeroes the f32 dQ accumulator (B, H, S, D); a row is
//      D / 8 threads of 16 bytes each, reduced with shuffles;
//   2. the main pass: one block of 8 warps per (K/V tile, batch*head), the
//      first tiles (which the most rows of a causal head see) dispatched
//      first across all heads. K and V stay in shared memory; the block
//      loops over the Q tiles that see its keys, Q and dO passing through a
//      two-stage cp.async ring. Per Q tile:
//        S = Q K^T and dP = dO V^T in f32 registers; P and dS formed there
//        (exponentials by ex2.approx) and stored as the input type to
//        swizzled shared tiles;
//        dV += P^T dO and dK += dS^T Q, accumulated in f32 registers for
//        the whole loop, P^T and dS^T read transposed from shared memory;
//        dQ += dS K, added into the f32 accumulator by vector reductions
//        (red.global.add.v2.f32).
//      D 64 (flash_bwd_wgmma_kernel): 64 keys and 128-row Q tiles;
//      warpgroup w computes S and dP of rows 64w .. 64w + 63 (wgmma, all
//      operands K-major) and dQ of the same rows from dS in registers (K
//      through the transpose bit); warpgroup 0 accumulates dV, warpgroup 1
//      dK (P^T, dS^T, dO and Q through the transpose bits, 128 rows of
//      contraction). Other D (flash_bwd_mma_kernel): mma.sync m16n8k16 with
//      ldmatrix, 64-row Q tiles and kBwdBN = 64 keys (128 for D 16), a
//      warp owning 16 rows x half the keys of S and dP and 16 keys of
//      dK/dV. Warps and warpgroups skip the parts of a causal tile that
//      they know are hidden;
//   3. flash_bwd_dq_convert_kernel: dQ from the accumulator to the input
//      type, in (B, S, H, D) memory, 16 bytes a thread.
//   Order of the dQ sum: the reductions add the K tiles' contributions in
//   the order the blocks reach them, which changes from run to run, so dQ
//   may differ between two runs by a few f32 roundings before it is
//   rounded to the input type (dK and dV are deterministic). The
//   reference sums in yet another order; the kernels are held to it at
//   2e-2 of max(1, |plain|), which covers this.
// What this does about the first kernels' limits: scores, P and dS no
// longer go through f32 shared scratch tiles; the products are wgmma or
// mma.sync reading swizzled tiles; copies overlap products; the dQ pass
// that recomputed S and dP (seven tile products for five) is gone; dl is
// one kernel instead of PyTorch element-wise passes. Measured alternatives
// (mxnet_tpu_torch/tools/flash_variants.py): mma.sync at D 64, with 64-
// and 128-key tiles.
//
// f32 (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel) keeps the first,
// deterministic two-pass design in true fp32 (FFMA), after the same
// preprocess kernel: 1. dK/dV per K tile over the Q tiles that see it;
// 2. dQ per Q tile over the K tiles it sees, P and dS recomputed.

#include "flash_common.cuh"

namespace {

using namespace mxt_flash;

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float *lse, *g_lse;  // g_lse: the cotangent of lse, or null
  float *dl, *dq_acc;        // dq_acc: f32 (B, H, S, D), 16-bit types only
  void *dq, *dk, *dv;
  View vq, vk, vv, vo, vdo, vdq, vdk, vdv;
  int B, H, S, causal, offset;
  float scale;
  bool vec;  // every row of every 16-bit view starts on a 16-byte boundary
};

// ---------------------------------------------------------------------------
// Preprocess: dl, and a zeroed dQ accumulator
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_kernel(Args a) {
  constexpr int kLanes = D / 8;  // threads per row, 8 elements each
  const int64_t rows = (int64_t)a.B * a.H * a.S;
  const int64_t gid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t r = gid / kLanes;
  const int part = gid % kLanes, c = part * 8;
  float acc = 0.f;
  if (r < rows) {
    const int bh = r / a.S, s = r % a.S, b = bh / a.H, h = bh % a.H;
    const T* o = static_cast<const T*>(a.out) + b * a.vo.sb + h * a.vo.sh +
                 s * a.vo.ss + c;
    const T* d = static_cast<const T*>(a.dout) + b * a.vdo.sb +
                 h * a.vdo.sh + s * a.vdo.ss + c;
    if constexpr (sizeof(T) == 2) {
      if (a.vec) {
        const uint4 ov = *reinterpret_cast<const uint4*>(o);
        const uint4 dv = *reinterpret_cast<const uint4*>(d);
        const T* op = reinterpret_cast<const T*>(&ov);
        const T* dp = reinterpret_cast<const T*>(&dv);
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += to_f32(op[e]) * to_f32(dp[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) acc += to_f32(o[e]) * to_f32(d[e]);
      }
      float4* z = reinterpret_cast<float4*>(a.dq_acc + r * D + c);
      z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += o[e] * d[e];
    }
  }
  // the kLanes threads of a row are neighbours in one warp
#pragma unroll
  for (int w = kLanes / 2; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (r < rows && part == 0)
    a.dl[r] = acc - (a.g_lse != nullptr ? a.g_lse[r] : 0.f);
}

// ---------------------------------------------------------------------------
// bf16/f16: one-pass tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int kBwdBM = 64;  // query rows per Q tile
constexpr int kBwdBN = 64;  // keys per block (128 for D 16)

template <int D>
struct BwdLayout {
  static constexpr int BM = kBwdBM;
  // D 16 takes 128 keys, so that a warp's share of dK/dV stays 16 wide
  static constexpr int BN = D == 16 ? 128 : kBwdBN;
  static constexpr int SW = BN / 2;           // S/dP keys per warp
  static constexpr int KG = BN / 16;          // dK/dV key groups of 16
  static constexpr int DW = D / (8 / KG);     // dK/dV columns per warp
  static constexpr int QW = D / 2;            // dQ columns per warp
  static constexpr size_t kKV = (size_t)BN * D;   // elements
  static constexpr size_t kQ = (size_t)BM * D;
  static constexpr size_t kP = (size_t)BM * BN;
  static constexpr size_t kBytes = 2 * (2 * kKV + 4 * kQ + 2 * kP);
  // f32 accumulators a thread holds while S and dP are live
  static constexpr int kAcc = (2 * BN * D + 2 * BM * BN) / kThreads;
  static constexpr int kMinBlocks = kAcc <= 80 ? 2 : 1;
  static_assert(KG <= 8 && DW >= 16, "warp layout");
  static_assert(4 * kQ >= 2 * kKV, "the ring must hold dK and dV");
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, BwdLayout<D>::kMinBlocks)
flash_bwd_mma_kernel(Args a) {
  using L = BwdLayout<D>;
  constexpr int BM = L::BM, BN = L::BN, SW = L::SW, DW = L::DW, QW = L::QW;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem);
  T* sv = sk + L::kKV;
  T* ring = sv + L::kKV;  // stage s: Q at ring + 2 s kQ, dO after it
  T* sp = ring + 4 * L::kQ;
  T* sds = sp + L::kP;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, S = a.S;
  const int k0 = blockIdx.y * BN;  // the first K tiles see the most rows
  const T* qb = static_cast<const T*>(a.q) + b * a.vq.sb + h * a.vq.sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.vdo.sb + h * a.vdo.sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.vk.sb + h * a.vk.sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vv.sb + h * a.vv.sh;
  const float* lse_b = a.lse + (int64_t)bh * S;
  const float* dl_b = a.dl + (int64_t)bh * S;
  float* dqa = a.dq_acc + (int64_t)bh * S * D;

  const int nq = (S + BM - 1) / BM;
  int i_start = 0;
  if (a.causal) {
    // the first Q tile with a row r that sees column k0: r + offset >= k0
    const int first_row = k0 - a.offset;
    i_start = first_row <= 0 ? 0 : min(nq, first_row / BM);
  }
  load_rows<T, D, BN, kThreads>(sk, kb, a.vk.ss, k0, S, a.vec);
  load_rows<T, D, BN, kThreads>(sv, vb, a.vv.ss, k0, S, a.vec);
  if (i_start < nq) {
    load_rows<T, D, BM, kThreads>(ring, qb, a.vq.ss, i_start * BM, S, a.vec);
    load_rows<T, D, BM, kThreads>(ring + L::kQ, dob, a.vdo.ss, i_start * BM,
                                  S, a.vec);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;   // fragment row and column pair
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix matrix and row
  const int sr = (warp & 3) * 16, sc = (warp >> 2) * SW;  // S/dP part
  const int kr = (warp % L::KG) * 16, kc = (warp / L::KG) * DW;  // dK/dV
  const int qr = (warp & 3) * 16, qc = (warp >> 2) * QW;  // dQ part
  const float c = a.scale * kLog2e;

  float dk[DW / 8][4], dv[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = i_start; i < nq; ++i) {
    const int it = i - i_start;
    if (i + 1 < nq) {
      T* nxt = ring + ((it + 1) & 1) * 2 * L::kQ;
      load_rows<T, D, BM, kThreads>(nxt, qb, a.vq.ss, (i + 1) * BM, S, a.vec);
      load_rows<T, D, BM, kThreads>(nxt + L::kQ, dob, a.vdo.ss, (i + 1) * BM,
                                    S, a.vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int q0 = i * BM;
    const T* sq = ring + (it & 1) * 2 * L::kQ;
    const T* sdo = sq + L::kQ;

    // 1. S and dP of rows sr.., keys sc..; P and dS to shared memory
    {
      const int r0 = q0 + sr + g, r1 = r0 + 8;
      float s[SW / 8][4], dp[SW / 8][4];
#pragma unroll
      for (int n = 0; n < SW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
      const bool hidden = a.causal && k0 + sc > q0 + sr + 15 + a.offset;
      if (!hidden) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t aq[4], ad[4];
          const int off = swz<D>(sr + mr + (mi & 1) * 8, kk * 16 + (mi >> 1) * 8);
          ldsm_x4(aq, sq + off);
          ldsm_x4(ad, sdo + off);
#pragma unroll
          for (int nn = 0; nn < SW / 16; ++nn) {
            uint32_t bk[4], bv[4];
            const int koff = swz<D>(sc + nn * 16 + mr + (mi >> 1) * 8,
                                    kk * 16 + (mi & 1) * 8);
            ldsm_x4(bk, sk + koff);
            ldsm_x4(bv, sv + koff);
            mma16816<T>(s[2 * nn], aq, bk[0], bk[1]);
            mma16816<T>(s[2 * nn + 1], aq, bk[2], bk[3]);
            mma16816<T>(dp[2 * nn], ad, bv[0], bv[1]);
            mma16816<T>(dp[2 * nn + 1], ad, bv[2], bv[3]);
          }
        }
        const float lse0 = (r0 < S ? lse_b[r0] : kNegInf);
        const float lse1 = (r1 < S ? lse_b[r1] : kNegInf);
        const float dl0 = r0 < S ? dl_b[r0] : 0.f;
        const float dl1 = r1 < S ? dl_b[r1] : 0.f;
        const bool masked =
            (a.causal && k0 + sc + SW - 1 > q0 + sr + a.offset) ||
            k0 + sc + SW > S || q0 + sr + 16 > S;
#pragma unroll
        for (int n = 0; n < SW / 8; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r0 : r1;
            const float lr = e < 2 ? lse0 : lse1;
            const float x = s[n][e] * c - lr * kLog2e;
            float p;
            if (!masked) {
              p = fast_exp2(x);  // every pair visible, so the row's lse is finite
            } else {
              const int col = k0 + sc + n * 8 + 2 * tq + (e & 1);
              const bool vis = row < S && col < S &&
                               (!a.causal || row + a.offset >= col) &&
                               lr > 0.5f * kNegInf;
              p = vis ? fast_exp2(fminf(x, 0.f)) : 0.f;
            }
            s[n][e] = p;
            dp[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1)) * a.scale;
          }
        }
      }
      // a hidden part stores P = dS = 0: other warps' products read it
#pragma unroll
      for (int n = 0; n < SW / 8; ++n) {
        const int col = sc + n * 8 + 2 * tq;
        *reinterpret_cast<uint32_t*>(sp + swz<BN>(sr + g, col)) =
            pack2<T>(s[n][0], s[n][1]);
        *reinterpret_cast<uint32_t*>(sp + swz<BN>(sr + g + 8, col)) =
            pack2<T>(s[n][2], s[n][3]);
        *reinterpret_cast<uint32_t*>(sds + swz<BN>(sr + g, col)) =
            pack2<T>(dp[n][0], dp[n][1]);
        *reinterpret_cast<uint32_t*>(sds + swz<BN>(sr + g + 8, col)) =
            pack2<T>(dp[n][2], dp[n][3]);
      }
    }
    __syncthreads();

    // 2. dV += P^T dO and dK += dS^T Q for keys kr.., columns kc..
    if (!(a.causal && k0 + kr > q0 + BM - 1 + a.offset)) {
#pragma unroll
      for (int kk = 0; kk < BM / 16; ++kk) {
        uint32_t ap[4], as[4];
        const int poff = swz<BN>(kk * 16 + mr + (mi >> 1) * 8, kr + (mi & 1) * 8);
        ldsm_x4_t(ap, sp + poff);
        ldsm_x4_t(as, sds + poff);
#pragma unroll
        for (int dd = 0; dd < DW / 16; ++dd) {
          uint32_t bo[4], bq[4];
          const int off = swz<D>(kk * 16 + mr + (mi & 1) * 8,
                                 kc + dd * 16 + (mi >> 1) * 8);
          ldsm_x4_t(bo, sdo + off);
          ldsm_x4_t(bq, sq + off);
          mma16816<T>(dv[2 * dd], ap, bo[0], bo[1]);
          mma16816<T>(dv[2 * dd + 1], ap, bo[2], bo[3]);
          mma16816<T>(dk[2 * dd], as, bq[0], bq[1]);
          mma16816<T>(dk[2 * dd + 1], as, bq[2], bq[3]);
        }
      }
    }

    // 3. dQ += dS K for rows qr.., columns qc.., into the f32 accumulator
    if (!(a.causal && k0 > q0 + qr + 15 + a.offset)) {
      float dq[QW / 8][4];
#pragma unroll
      for (int n = 0; n < QW / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        uint32_t as[4];
        ldsm_x4(as, sds + swz<BN>(qr + mr + (mi & 1) * 8, kk * 16 + (mi >> 1) * 8));
#pragma unroll
        for (int dd = 0; dd < QW / 16; ++dd) {
          uint32_t bk[4];
          ldsm_x4_t(bk, sk + swz<D>(kk * 16 + mr + (mi & 1) * 8,
                                    qc + dd * 16 + (mi >> 1) * 8));
          mma16816<T>(dq[2 * dd], as, bk[0], bk[1]);
          mma16816<T>(dq[2 * dd + 1], as, bk[2], bk[3]);
        }
        if constexpr (QW % 16 == 8) {  // D 16: one 8-column tile
          uint32_t bk[2];
          ldsm_x2_t(bk, sk + swz<D>(kk * 16 + (lane & 15), qc + QW - 8));
          mma16816<T>(dq[QW / 8 - 1], as, bk[0], bk[1]);
        }
      }
      const int r0 = q0 + qr + g, r1 = r0 + 8;
#pragma unroll
      for (int n = 0; n < QW / 8; ++n) {
        const int col = qc + n * 8 + 2 * tq;
        if (r0 < S) red_add2(dqa + (int64_t)r0 * D + col, dq[n][0], dq[n][1]);
        if (r1 < S) red_add2(dqa + (int64_t)r1 * D + col, dq[n][2], dq[n][3]);
      }
    }
    __syncthreads();  // before the next tile overwrites P, dS and the stage
  }
  cp_async_wait<0>();
  __syncthreads();

  // dK and dV: staged as the input type in the ring, then 16-byte rows
  T* sdk = ring;
  T* sdv = ring + L::kKV;
#pragma unroll
  for (int n = 0; n < DW / 8; ++n) {
    const int col = kc + n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(sdk + swz<D>(kr + g, col)) =
        pack2<T>(dk[n][0], dk[n][1]);
    *reinterpret_cast<uint32_t*>(sdk + swz<D>(kr + g + 8, col)) =
        pack2<T>(dk[n][2], dk[n][3]);
    *reinterpret_cast<uint32_t*>(sdv + swz<D>(kr + g, col)) =
        pack2<T>(dv[n][0], dv[n][1]);
    *reinterpret_cast<uint32_t*>(sdv + swz<D>(kr + g + 8, col)) =
        pack2<T>(dv[n][2], dv[n][3]);
  }
  __syncthreads();
  T* dkb = static_cast<T*>(a.dk) + b * a.vdk.sb + h * a.vdk.sh;
  T* dvb = static_cast<T*>(a.dv) + b * a.vdv.sb + h * a.vdv.sh;
  store_rows<T, D, BN>(dkb, a.vdk.ss, sdk, k0, S, a.vec, threadIdx.x,
                       kThreads);
  store_rows<T, D, BN>(dvb, a.vdv.ss, sdv, k0, S, a.vec, threadIdx.x,
                       kThreads);
}

// D 64: the same pass on warpgroup products (wgmma m64n64k16; tiles of
// 128-byte rows, the hardware's swizzle, on 1024-byte boundaries). A block
// takes 64 keys and 128-row Q tiles; warpgroup w owns rows 64w .. 64w + 63:
//   S = Q K^T and dP = dO V^T (both operands K-major in shared memory);
//   P and dS in registers, stored to shared memory for the next products,
//   dS also kept as A fragments;
//   warpgroup 0: dV += P^T dO, warpgroup 1: dK += dS^T Q (P^T, dS^T and
//   dO, Q read through the transpose bits, 128 rows of contraction);
//   both: dQ += dS K (dS from registers, K through the transpose bit),
//   added into the f32 accumulator.
constexpr int kWgBM = 128;  // query rows per Q tile
constexpr int kWgBN = 64;   // keys per block

struct BwdWgLayout {
  static constexpr size_t kKV = (size_t)kWgBN * 64;  // elements
  static constexpr size_t kQ = (size_t)kWgBM * 64;
  // K, V, two stages of Q and dO, P, dS; and room for a 1024-byte start
  static constexpr size_t kBytes = 2 * (2 * kKV + 4 * kQ + 2 * kQ) + 1024;
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_wgmma_kernel(Args a) {
  using L = BwdWgLayout;
  constexpr int D = 64, BM = kWgBM, BN = kWgBN;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sk = reinterpret_cast<T*>(smem + ((1024 - (smem_u32(smem) & 1023)) & 1023));
  T* sv = sk + L::kKV;
  T* ring = sv + L::kKV;  // stage s: Q at ring + 2 s kQ, dO after it
  T* sp = ring + 4 * L::kQ;
  T* sds = sp + L::kQ;

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, S = a.S;
  const int k0 = blockIdx.y * BN;  // the first K tiles see the most rows
  const T* qb = static_cast<const T*>(a.q) + b * a.vq.sb + h * a.vq.sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.vdo.sb + h * a.vdo.sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.vk.sb + h * a.vk.sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vv.sb + h * a.vv.sh;
  const float* lse_b = a.lse + (int64_t)bh * S;
  const float* dl_b = a.dl + (int64_t)bh * S;
  float* dqa = a.dq_acc + (int64_t)bh * S * D;

  const int nq = (S + BM - 1) / BM;
  int i_start = 0;
  if (a.causal) {
    // the first Q tile with a row r that sees column k0: r + offset >= k0
    const int first_row = k0 - a.offset;
    i_start = first_row <= 0 ? 0 : min(nq, first_row / BM);
  }
  load_rows<T, D, BN, kThreads>(sk, kb, a.vk.ss, k0, S, a.vec);
  load_rows<T, D, BN, kThreads>(sv, vb, a.vv.ss, k0, S, a.vec);
  if (i_start < nq) {
    load_rows<T, D, BM, kThreads>(ring, qb, a.vq.ss, i_start * BM, S, a.vec);
    load_rows<T, D, BM, kThreads>(ring + L::kQ, dob, a.vdo.ss, i_start * BM,
                                  S, a.vec);
  }
  cp_async_commit();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;  // fragment row and column pair
  const int wg = warp >> 2, wr = warp * 16;  // warpgroup; the warp's rows
  const float c = a.scale * kLog2e;

  float dkv[8][4];  // warpgroup 0: dV, 1: dK (rows: keys 16 (warp % 4) ..)
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dkv[n][e] = 0.f;

  for (int i = i_start; i < nq; ++i) {
    const int it = i - i_start;
    if (i + 1 < nq) {
      T* nxt = ring + ((it + 1) & 1) * 2 * L::kQ;
      load_rows<T, D, BM, kThreads>(nxt, qb, a.vq.ss, (i + 1) * BM, S, a.vec);
      load_rows<T, D, BM, kThreads>(nxt + L::kQ, dob, a.vdo.ss, (i + 1) * BM,
                                    S, a.vec);
    }
    cp_async_commit();
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    const int q0 = i * BM;
    const T* sq = ring + (it & 1) * 2 * L::kQ;
    const T* sdo = sq + L::kQ;

    // 1. S and dP of the warpgroup's 64 rows; P and dS
    const bool hidden = a.causal && k0 > q0 + 64 * wg + 63 + a.offset;
    float s[8][4], dp[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    if (!hidden) {
      wgmma_ss<T, 0, 0>(s, smem_u32(sq + 64 * wg * D), smem_u32(sk));
      wgmma_ss<T, 0, 0>(dp, smem_u32(sdo + 64 * wg * D), smem_u32(sv));
      const int r0 = q0 + wr + g, r1 = r0 + 8;
      const float lse0 = r0 < S ? lse_b[r0] : kNegInf;
      const float lse1 = r1 < S ? lse_b[r1] : kNegInf;
      const float dl0 = r0 < S ? dl_b[r0] : 0.f;
      const float dl1 = r1 < S ? dl_b[r1] : 0.f;
      const bool masked = (a.causal && k0 + BN - 1 > q0 + wr + a.offset) ||
                          k0 + BN > S || q0 + wr + 16 > S;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = e < 2 ? r0 : r1;
          const float lr = e < 2 ? lse0 : lse1;
          const float x = s[n][e] * c - lr * kLog2e;
          float p;
          if (!masked) {
            p = fast_exp2(x);  // every pair visible: the row's lse is finite
          } else {
            const int col = k0 + n * 8 + 2 * tq + (e & 1);
            const bool vis = row < S && col < S &&
                             (!a.causal || row + a.offset >= col) &&
                             lr > 0.5f * kNegInf;
            p = vis ? fast_exp2(fminf(x, 0.f)) : 0.f;
          }
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - (e < 2 ? dl0 : dl1)) * a.scale;
        }
      }
    }
    // P and dS as the input type: to shared memory (zero where hidden:
    // the other warpgroup's dV or dK reads them) and dS as A fragments
    uint32_t dsa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      dsa[kk][0] = pack2<T>(dp[2 * kk][0], dp[2 * kk][1]);
      dsa[kk][1] = pack2<T>(dp[2 * kk][2], dp[2 * kk][3]);
      dsa[kk][2] = pack2<T>(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      dsa[kk][3] = pack2<T>(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * tq;
      *reinterpret_cast<uint32_t*>(sp + swz<D>(wr + g, col)) =
          pack2<T>(s[n][0], s[n][1]);
      *reinterpret_cast<uint32_t*>(sp + swz<D>(wr + g + 8, col)) =
          pack2<T>(s[n][2], s[n][3]);
      *reinterpret_cast<uint32_t*>(sds + swz<D>(wr + g, col)) =
          dsa[n / 2][(n & 1) * 2];
      *reinterpret_cast<uint32_t*>(sds + swz<D>(wr + g + 8, col)) =
          dsa[n / 2][(n & 1) * 2 + 1];
    }
    fence_proxy_async();
    __syncthreads();

    // 2. warpgroup 0: dV += P^T dO; warpgroup 1: dK += dS^T Q
    {
      const T* ta = wg == 0 ? sp : sds;
      const T* tb = wg == 0 ? sdo : sq;
      wgmma_ss<T, 1, 1>(dkv, smem_u32(ta), smem_u32(tb));
      wgmma_ss<T, 1, 1>(dkv, smem_u32(ta + 64 * D), smem_u32(tb + 64 * D));
    }

    // 3. dQ += dS K for the warpgroup's rows
    if (!hidden) {
      float dq[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;
      wgmma_rs<T>(dq, dsa, smem_u32(sk));
      const int r0 = q0 + wr + g, r1 = r0 + 8;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int col = n * 8 + 2 * tq;
        if (r0 < S) red_add2(dqa + (int64_t)r0 * D + col, dq[n][0], dq[n][1]);
        if (r1 < S) red_add2(dqa + (int64_t)r1 * D + col, dq[n][2], dq[n][3]);
      }
    }
    __syncthreads();  // before the next tile overwrites P, dS and the stage
  }
  cp_async_wait<0>();
  __syncthreads();

  // dV (warpgroup 0) and dK (warpgroup 1): staged as the input type in the
  // ring, then 16-byte rows
  T* sdv = ring;
  T* sdk = ring + L::kKV;
  T* so = wg == 0 ? sdv : sdk;
  const int kr = (warp & 3) * 16;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * tq;
    *reinterpret_cast<uint32_t*>(so + swz<D>(kr + g, col)) =
        pack2<T>(dkv[n][0], dkv[n][1]);
    *reinterpret_cast<uint32_t*>(so + swz<D>(kr + g + 8, col)) =
        pack2<T>(dkv[n][2], dkv[n][3]);
  }
  __syncthreads();
  T* dkb = static_cast<T*>(a.dk) + b * a.vdk.sb + h * a.vdk.sh;
  T* dvb = static_cast<T*>(a.dv) + b * a.vdv.sb + h * a.vdv.sh;
  store_rows<T, D, BN>(dkb, a.vdk.ss, sdk, k0, S, a.vec, threadIdx.x,
                       kThreads);
  store_rows<T, D, BN>(dvb, a.vdv.ss, sdv, k0, S, a.vec, threadIdx.x,
                       kThreads);
}

// dQ (input type, strided) from the f32 accumulator, 8 elements a thread.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_convert_kernel(Args a) {
  constexpr int kLanes = D / 8;
  const int64_t rows = (int64_t)a.B * a.H * a.S;
  const int64_t gid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t r = gid / kLanes;
  if (r >= rows) return;
  const int c = (gid % kLanes) * 8;
  const int bh = r / a.S, s = r % a.S, b = bh / a.H, h = bh % a.H;
  const float4* src = reinterpret_cast<const float4*>(a.dq_acc + r * D + c);
  const float4 x = src[0], y = src[1];
  T* dst = static_cast<T*>(a.dq) + b * a.vdq.sb + h * a.vdq.sh +
           s * a.vdq.ss + c;
  if (a.vec) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack2<T>(x.x, x.y), pack2<T>(x.z, x.w),
                   pack2<T>(y.x, y.y), pack2<T>(y.z, y.w));
  } else {
    const float f[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 8; ++e) dst[e] = from_f32<T>(f[e]);
  }
}

// ---------------------------------------------------------------------------
// f32: two FFMA passes
// ---------------------------------------------------------------------------

constexpr int kElems = kBQ * kBK / kThreads;  // score elements per thread

// From the scores S (in sf) and dP = dO V^T (in sg) of the (q0, k0) tile:
// P = exp(S * scale - lse) into sp (skipped when null) and
// dS = P * (dP - dl) * scale into sds.
template <int kLdF, int kLdP>
__device__ __forceinline__ void probs_dscores(float* sp, float* sds,
                                              const float* sf,
                                              const float* sg,
                                              const float* s_lse,
                                              const float* s_dl, int q0,
                                              int k0, const Args& a) {
  const float c = a.scale * kLog2e;
  const bool masked = (a.causal && k0 + kBK - 1 > q0 + a.offset) ||
                      k0 + kBK > a.S || q0 + kBQ > a.S;
#pragma unroll 4
  for (int e = 0; e < kElems; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / kBK, cc = idx % kBK;
    const float x = sf[r * kLdF + cc] * c - s_lse[r] * kLog2e;
    float p;
    if (!masked) {
      p = exp2f(x);  // every pair visible, so the row's lse is finite
    } else {
      const int qr = q0 + r, kc = k0 + cc;
      const bool vis = qr < a.S && kc < a.S &&
                       (!a.causal || qr + a.offset >= kc) &&
                       s_lse[r] > 0.5f * kNegInf;
      p = vis ? exp2f(fminf(x, 0.f)) : 0.f;
    }
    if (sp != nullptr) sp[r * kLdP + cc] = p;
    sds[r * kLdP + cc] = p * (sg[r * kLdF + cc] - s_dl[r]) * a.scale;
  }
}

// lse and dl of rows row0 .. row0+63 (rows past S: -1e30 and 0).
__device__ __forceinline__ void load_row_stats(float* s_lse, float* s_dl,
                                               const float* lse,
                                               const float* dl, int64_t base,
                                               int row0, int S) {
  if (threadIdx.x < 64) {
    const int s = row0 + threadIdx.x;
    s_lse[threadIdx.x] = s < S ? lse[base + s] : kNegInf;
    s_dl[threadIdx.x] = s < S ? dl[base + s] : 0.f;
  }
}

template <int D>
__device__ __forceinline__ void store_tile(float* dst, int64_t ss,
                                           const float* acc, int row0, int S) {
  constexpr int kAcc = 64 * D / kThreads;
#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / D, d = idx % D;
    if (row0 + r < S) dst[(int64_t)(row0 + r) * ss + d] = acc[e];
  }
}

template <int D, int kLdF>
__device__ __forceinline__ void accumulate(float* acc, const float* sf) {
  constexpr int kAcc = 64 * D / kThreads;
#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    acc[e] += sf[(idx / D) * kLdF + idx % D];
  }
}

// Pass 1: dK and dV of one K tile. Per Q tile: S and dP, then P and dS,
// then P^T dO and dS^T Q; four barriers.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkdv_kernel(Args a) {
  using L = Smem<D>;
  constexpr int kLdT = L::kLdT, kLdP = L::kLdP, kLdF = L::kLdF;
  constexpr int kAcc = 64 * D / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sq = at<float>(smem, L::kA);
  float* sdo = at<float>(smem, L::kB);
  float* sk = at<float>(smem, L::kC);
  float* sv = at<float>(smem, L::kD);
  float* sp = at<float>(smem, L::kP);
  float* sds = at<float>(smem, L::kDS);
  float* sf = at<float>(smem, L::kF);
  float* sg = at<float>(smem, L::kG);
  float* s_lse = at<float>(smem, L::kRow0);
  float* s_dl = at<float>(smem, L::kRow1);

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const int k0 = blockIdx.x * kBK;  // the first K tiles see the most rows
  const float* qb = static_cast<const float*>(a.q) + b * a.vq.sb + h * a.vq.sh;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.vdo.sb + h * a.vdo.sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.vk.sb + h * a.vk.sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vv.sb + h * a.vv.sh;
  load_tile<D, kLdT>(sk, kb, a.vk.ss, k0, S);
  load_tile<D, kLdT>(sv, vb, a.vv.ss, k0, S);

  const int nq = (S + kBQ - 1) / kBQ;
  int i_start = 0;
  if (a.causal) {
    // the first Q tile with a row r that sees column k0: r + offset >= k0
    const int first_row = k0 - a.offset;
    i_start = first_row <= 0 ? 0 : min(nq, first_row / kBQ);
  }
  float dk[kAcc], dv[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) dk[e] = dv[e] = 0.f;

  for (int i = i_start; i < nq; ++i) {
    const int q0 = i * kBQ;
    load_tile<D, kLdT>(sq, qb, a.vq.ss, q0, S);
    load_tile<D, kLdT>(sdo, dob, a.vdo.ss, q0, S);
    load_row_stats(s_lse, s_dl, a.lse, a.dl, (int64_t)bh * S, q0, S);
    __syncthreads();
    mm<true, false, kBQ, kBK, D>(sf, kLdF, sq, kLdT, sk, kLdT);  // Q K^T
    mm<true, false, kBQ, kBK, D>(sg, kLdF, sdo, kLdT, sv, kLdT);  // dO V^T
    __syncthreads();
    probs_dscores<kLdF, kLdP>(sp, sds, sf, sg, s_lse, s_dl, q0, k0, a);
    __syncthreads();
    mm<false, true, kBK, D, kBQ>(sf, kLdF, sp, kLdP, sdo, kLdT);  // P^T dO
    mm<false, true, kBK, D, kBQ>(sg, kLdF, sds, kLdP, sq, kLdT);  // dS^T Q
    __syncthreads();
    accumulate<D, kLdF>(dv, sf);
    accumulate<D, kLdF>(dk, sg);
  }
  float* dkb = static_cast<float*>(a.dk) + b * a.vdk.sb + h * a.vdk.sh;
  float* dvb = static_cast<float*>(a.dv) + b * a.vdv.sb + h * a.vdv.sh;
  store_tile<D>(dkb, a.vdk.ss, dk, k0, S);
  store_tile<D>(dvb, a.vdv.ss, dv, k0, S);
}

// Pass 2: dQ of one Q tile. Per K tile: S and dP, then dS, then dS K.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_kernel(Args a) {
  using L = Smem<D>;
  constexpr int kLdT = L::kLdT, kLdP = L::kLdP, kLdF = L::kLdF;
  constexpr int kAcc = 64 * D / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sq = at<float>(smem, L::kA);
  float* sdo = at<float>(smem, L::kB);
  float* sk = at<float>(smem, L::kC);
  float* sv = at<float>(smem, L::kD);
  float* sds = at<float>(smem, L::kDS);
  float* sf = at<float>(smem, L::kF);
  float* sg = at<float>(smem, L::kG);
  float* s_lse = at<float>(smem, L::kRow0);
  float* s_dl = at<float>(smem, L::kRow1);

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const float* qb = static_cast<const float*>(a.q) + b * a.vq.sb + h * a.vq.sh;
  const float* dob =
      static_cast<const float*>(a.dout) + b * a.vdo.sb + h * a.vdo.sh;
  const float* kb = static_cast<const float*>(a.k) + b * a.vk.sb + h * a.vk.sh;
  const float* vb = static_cast<const float*>(a.v) + b * a.vv.sb + h * a.vv.sh;
  load_tile<D, kLdT>(sq, qb, a.vq.ss, q0, S);
  load_tile<D, kLdT>(sdo, dob, a.vdo.ss, q0, S);
  load_row_stats(s_lse, s_dl, a.lse, a.dl, (int64_t)bh * S, q0, S);

  const int nk = (S + kBK - 1) / kBK;
  int nk_run = nk;
  if (a.causal) {
    const int last_col = min(q0 + kBQ, S) - 1 + a.offset;
    nk_run = last_col < 0 ? 0 : min(nk, last_col / kBK + 1);
  }
  float dq[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) dq[e] = 0.f;

  for (int j = 0; j < nk_run; ++j) {
    const int k0 = j * kBK;
    load_tile<D, kLdT>(sk, kb, a.vk.ss, k0, S);
    load_tile<D, kLdT>(sv, vb, a.vv.ss, k0, S);
    __syncthreads();
    mm<true, false, kBQ, kBK, D>(sf, kLdF, sq, kLdT, sk, kLdT);  // Q K^T
    mm<true, false, kBQ, kBK, D>(sg, kLdF, sdo, kLdT, sv, kLdT);  // dO V^T
    __syncthreads();
    probs_dscores<kLdF, kLdP>(nullptr, sds, sf, sg, s_lse, s_dl, q0, k0, a);
    __syncthreads();
    mm<true, true, kBQ, D, kBK>(sf, kLdF, sds, kLdP, sk, kLdT);  // dS K
    __syncthreads();
    accumulate<D, kLdF>(dq, sf);
  }
  float* dqb = static_cast<float*>(a.dq) + b * a.vdq.sb + h * a.vdq.sh;
  store_tile<D>(dqb, a.vdq.ss, dq, q0, S);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Blocks of the preprocess and convert kernels: D / 8 threads per row.
inline dim3 row_grid(const Args& a, int D) {
  const int64_t threads = (int64_t)a.B * a.H * a.S * (D / 8);
  return dim3((unsigned)((threads + kThreads - 1) / kThreads));
}

template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  using L = Smem<D>;
  auto dkdv = flash_bwd_dkdv_kernel<D>;
  auto dq = flash_bwd_dq_kernel<D>;
  cudaError_t err = prepare(dkdv, L::kBytes, a.B, a.H);
  if (err == cudaSuccess) err = prepare(dq, L::kBytes, a.B, a.H);
  if (err != cudaSuccess) return err;
  flash_bwd_preprocess_kernel<float, D><<<row_grid(a, D), kThreads, 0,
                                          stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.S + kBK - 1) / kBK, a.B * a.H);
  dkdv<<<grid_k, kThreads, L::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.S + kBQ - 1) / kBQ, a.B * a.H);
  dq<<<grid_q, kThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

// The three kernels of the 16-bit pass, the main one `fn` on tiles of bn
// keys with `bytes` of shared memory.
template <typename T, int D, typename Fn>
cudaError_t launch_pass(Fn fn, size_t bytes, int bn, const Args& a,
                        cudaStream_t stream) {
  if (a.dq_acc == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = prepare(fn, bytes, a.B, a.H);
  if (err != cudaSuccess) return err;
  flash_bwd_preprocess_kernel<T, D><<<row_grid(a, D), kThreads, 0, stream>>>(
      a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(a.B * a.H, (a.S + bn - 1) / bn);
  fn<<<grid, kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dq_convert_kernel<T, D><<<row_grid(a, D), kThreads, 0, stream>>>(
      a);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  if constexpr (D == 64)
    return launch_pass<T, D>(flash_bwd_wgmma_kernel<T>, BwdWgLayout::kBytes,
                             kWgBN, a, stream);
  else
    return launch_pass<T, D>(flash_bwd_mma_kernel<T, D>, BwdLayout<D>::kBytes,
                             BwdLayout<D>::BN, a, stream);
}

template <int D>
cudaError_t launch(int dtype, const Args& a, cudaStream_t stream) {
  switch (dtype) {
    case 0:
      return launch_f32<D>(a, stream);
    case 1:
      return launch_mma<__nv_bfloat16, D>(a, stream);
    case 2:
      return launch_mma<__half, D>(a, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, out, dout, dq,
// dk and dv share it). strides: 24 element strides, (b, h, s) of q, k, v,
// out, dout, dq, dk and dv in that order, each with a contiguous last
// dimension. lse, g_lse (the cotangent of lse, or null) and dl (scratch
// for dl): contiguous (B, H, S) float32. dq_acc: contiguous (B, H, S, D)
// float32 scratch for the 16-bit types, ignored for float32. D must be 16,
// 32, 64 or 128. Launches every kernel on `stream`; returns the first
// cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const float* lse,
                                   const float* g_lse, float* dl,
                                   float* dq_acc, void* dq, void* dk,
                                   void* dv, int dtype, int B, int H, int S,
                                   int D, const long long* strides,
                                   int causal, int offset, float scale,
                                   void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, dout, lse, g_lse, dl, dq_acc, dq, dk, dv,
         view(strides), view(strides + 3), view(strides + 6),
         view(strides + 9), view(strides + 12), view(strides + 15),
         view(strides + 18), view(strides + 21),
         B, H, S, causal, offset, scale, false};
  if (dtype != 0) {
    const void* ptrs[8] = {q, k, v, out, dout, dq, dk, dv};
    const View views[8] = {a.vq, a.vk, a.vv, a.vo, a.vdo, a.vdq, a.vdk, a.vdv};
    a.vec = true;
    for (int i = 0; i < 8; ++i) a.vec = a.vec && vec_ok(ptrs[i], views[i], 2);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16:
      return (int)launch<16>(dtype, a, st);
    case 32:
      return (int)launch<32>(dtype, a, st);
    case 64:
      return (int)launch<64>(dtype, a, st);
    case 128:
      return (int)launch<128>(dtype, a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
