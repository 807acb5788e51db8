// Flash-attention backward for Hopper (sm_90a): a plain C launcher and its
// CPython entry point (pyentry.cuh), built and imported by
// mxnet_tpu_torch/ops/_kernels.py.
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
//      dK/dV; at D 256, 32 keys a block, so that a warp's share of dK and
//      dV (16 keys x 64 columns each) and of dQ (16 rows x 128 columns)
//      stays in registers (shared memory: K and V 32 KB, two stages of Q
//      and dO 128 KB, P and dS 8 KB). Warps and warpgroups skip the parts
//      of a causal tile that they know are hidden;
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
// FFMA design (f32 at every head dim, in true fp32 as the reference's
// HIGHEST precision, no TF32; bf16/f16 above D 256, converted to f32 as
// they are loaded): one pass, five tile products, three kernels:
//   1. flash_bwd_rows_kernel: dl per row and a zeroed f32 dQ accumulator
//      of whole 64-column slabs, one warp a row, for any head dim;
//   2. flash_bwd_ffma_kernel: one block of 256 threads per (64-key tile,
//      batch*head, 64-column slab), 2 blocks an SM (108 KB of shared
//      memory), register tiles read as float4 (flash_common.cuh). Per Q
//      tile it recomputes S and dP over the whole head dim in chunks of
//      64 (its own slab's chunk last, so that it stays for the products),
//      stores P and dS transposed to shared memory, accumulates its slab of
//      dV and dK in registers and adds its slab of dQ = dS K into the
//      accumulator by red.global.add, the next Q tile's copies in flight
//      meanwhile. At D 64 there is one slab; wider heads run d / 64 slabs,
//      each recomputing S and dP;
//   3. flash_bwd_dq_store_kernel: dQ from the accumulator, for any head dim.
//   The first f32 design made two passes (dK/dV, then dQ, each recomputing
//   S and dP: seven tile products for five) with one thread per output
//   element of shared-memory products, bound by shared memory.
//   Determinism: dK and dV are summed in one order; f32 dQ, like the 16-bit
//   one, is summed by reductions in the order the blocks reach them, so two
//   runs may differ in its last bits.
//
// Fixed-order dQ (`det`, under torch.use_deterministic_algorithms; FFMA
// route only): the reference's grid walks the key tiles in order on one
// core (mxnet_tpu/ops/flash_attention.py:298-330), so its dQ sum has one
// order. Here the main pass skips step 4 and a fourth kernel,
// flash_bwd_dq_ordered_kernel, computes dQ: one block per (64-row Q tile,
// batch*head, 64-column slab) walks the key tiles its rows see in key
// order, recomputes S and dP (as the main pass does) and dS, and sums its
// slab of dQ = dS K in registers, each element by one chain of fmaf over
// the keys in order, then stores it once. Seven tile products for five,
// no scratch memory and no atomics: two runs give the same bits. The
// rows kernel then leaves the accumulator alone (there is none).
//
// Head dims to 256 of the 16-bit kernels run at the next built D (16, 32,
// 64, 128, 256) with the columns past the true d zero (flash_common.cuh);
// their f32 dQ accumulator is (B, H, S, D) at that D.

#include "pyentry.cuh"

#include "flash_common.cuh"

namespace {

using namespace mxt_flash;

struct Args {
  const void *q, *k, *v, *out, *dout;
  const float *lse, *g_lse;  // g_lse: the cotangent of lse, or null
  float *dl, *dq_acc;        // dq_acc: f32 (B, H, S, acc_w)
  void *dq, *dk, *dv;
  View vq, vk, vv, vo, vdo, vdq, vdk, vdv;
  int B, H, S, d, causal, offset;  // d: the true head dim, <= the kernel's
  float scale;
  bool vec;   // every row of every view starts on a 16-byte boundary
  int acc_w;  // row width of dq_acc: the padded D, or whole FFMA slabs
  int det;    // FFMA route: dQ summed in key-tile order, no accumulator
};

// ---------------------------------------------------------------------------
// Preprocess: dl, and a zeroed dQ accumulator
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_preprocess_kernel(Args a) {
  static_assert(sizeof(T) == 2, "16-bit only: the FFMA pass has its own");
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
    if (a.vec && c + 8 <= a.d) {
      const uint4 ov = *reinterpret_cast<const uint4*>(o);
      const uint4 dv = *reinterpret_cast<const uint4*>(d);
      const T* op = reinterpret_cast<const T*>(&ov);
      const T* dp = reinterpret_cast<const T*>(&dv);
#pragma unroll
      for (int e = 0; e < 8; ++e) acc += to_f32(op[e]) * to_f32(dp[e]);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        if (c + e < a.d) acc += to_f32(o[e]) * to_f32(d[e]);
    }
    float4* z = reinterpret_cast<float4*>(a.dq_acc + r * D + c);
    z[0] = z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
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
  // D 16 takes 128 keys, so that a warp's share of dK/dV stays 16 wide;
  // D 256 takes 32, so that it stays 64 wide (registers)
  static constexpr int BN = D == 16 ? 128 : D == 256 ? 32 : kBwdBN;
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
  static constexpr int kMinBlocks =
      kAcc <= 80 && 2 * kBytes <= 232448 ? 2 : 1;
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
  load_rows<T, D, BN, kThreads>(sk, kb, a.vk.ss, k0, S, a.d, a.vec);
  load_rows<T, D, BN, kThreads>(sv, vb, a.vv.ss, k0, S, a.d, a.vec);
  if (i_start < nq) {
    load_rows<T, D, BM, kThreads>(ring, qb, a.vq.ss, i_start * BM, S, a.d,
                                  a.vec);
    load_rows<T, D, BM, kThreads>(ring + L::kQ, dob, a.vdo.ss, i_start * BM,
                                  S, a.d, a.vec);
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
      load_rows<T, D, BM, kThreads>(nxt, qb, a.vq.ss, (i + 1) * BM, S, a.d,
                                    a.vec);
      load_rows<T, D, BM, kThreads>(nxt + L::kQ, dob, a.vdo.ss, (i + 1) * BM,
                                    S, a.d, a.vec);
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
  store_rows<T, D, BN>(dkb, a.vdk.ss, sdk, k0, S, a.d, a.vec, threadIdx.x,
                       kThreads);
  store_rows<T, D, BN>(dvb, a.vdv.ss, sdv, k0, S, a.d, a.vec, threadIdx.x,
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
  load_rows<T, D, BN, kThreads>(sk, kb, a.vk.ss, k0, S, a.d, a.vec);
  load_rows<T, D, BN, kThreads>(sv, vb, a.vv.ss, k0, S, a.d, a.vec);
  if (i_start < nq) {
    load_rows<T, D, BM, kThreads>(ring, qb, a.vq.ss, i_start * BM, S, a.d,
                                  a.vec);
    load_rows<T, D, BM, kThreads>(ring + L::kQ, dob, a.vdo.ss, i_start * BM,
                                  S, a.d, a.vec);
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
      load_rows<T, D, BM, kThreads>(nxt, qb, a.vq.ss, (i + 1) * BM, S, a.d,
                                    a.vec);
      load_rows<T, D, BM, kThreads>(nxt + L::kQ, dob, a.vdo.ss, (i + 1) * BM,
                                    S, a.d, a.vec);
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
  store_rows<T, D, BN>(dkb, a.vdk.ss, sdk, k0, S, a.d, a.vec, threadIdx.x,
                       kThreads);
  store_rows<T, D, BN>(dvb, a.vdv.ss, sdv, k0, S, a.d, a.vec, threadIdx.x,
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
  if (c >= a.d) return;
  if (a.vec && c + 8 <= a.d) {
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(pack2<T>(x.x, x.y), pack2<T>(x.z, x.w),
                   pack2<T>(y.x, y.y), pack2<T>(y.z, y.w));
  } else {
    const float f[8] = {x.x, x.y, x.z, x.w, y.x, y.y, y.z, y.w};
#pragma unroll
    for (int e = 0; e < 8; ++e)
      if (c + e < a.d) dst[e] = from_f32<T>(f[e]);
  }
}

// ---------------------------------------------------------------------------
// FFMA: f32 at every head dim, bf16/f16 above 256, one pass
// ---------------------------------------------------------------------------

// dl = rowsum(dO * out) - dlse per row and a zeroed row of the dQ
// accumulator (acc_w wide), for any head dim: one warp a row.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_rows_kernel(Args a) {
  const int64_t rows = (int64_t)a.B * a.H * a.S;
  const int64_t r = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (r >= rows) return;  // the whole warp
  const int bh = r / a.S, s = r % a.S, b = bh / a.H, h = bh % a.H;
  const T* o = static_cast<const T*>(a.out) + b * a.vo.sb + h * a.vo.sh +
               s * a.vo.ss;
  const T* g = static_cast<const T*>(a.dout) + b * a.vdo.sb + h * a.vdo.sh +
               s * a.vdo.ss;
  float acc = 0.f;
  for (int c = lane; c < a.d; c += 32) acc += to_f32(o[c]) * to_f32(g[c]);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (!a.det) {
    float4* z = reinterpret_cast<float4*>(a.dq_acc + r * a.acc_w);
    for (int c = lane; c < a.acc_w / 4; c += 32)
      z[c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (lane == 0) a.dl[r] = acc - (a.g_lse != nullptr ? a.g_lse[r] : 0.f);
}

// dQ (input type, strided) from the f32 accumulator, 4 columns a thread,
// for any head dim.
template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_store_kernel(Args a) {
  const int groups = (a.d + 3) / 4;
  const int64_t rows = (int64_t)a.B * a.H * a.S;
  const int64_t gid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t r = gid / groups;
  if (r >= rows) return;
  const int c = (gid % groups) * 4;
  const int bh = r / a.S, s = r % a.S, b = bh / a.H, h = bh % a.H;
  const float4 x =
      *reinterpret_cast<const float4*>(a.dq_acc + r * a.acc_w + c);
  store4<T>(static_cast<T*>(a.dq) + b * a.vdq.sb + h * a.vdq.sh +
                s * a.vdq.ss + c,
            x, a.d - c, a.vec);
}

// One block of 256 threads per (64-key tile, batch*head, slab of 64
// columns), the first key tiles (which the most rows of a causal head see)
// first. The block loops over the Q tiles that see its keys; per Q tile:
//   1. S = Q K^T and dP = dO V^T over the whole head dim, in chunks of 64
//      columns, the block's own slab last, so that after the loop the
//      chunk buffers hold the slab of Q, dO and K that steps 3-4 read;
//   2. P and dS (rounded to the input type, as the reference casts them)
//      to shared memory, stored transposed (key-major);
//   3. dV += P^T dO and dK += dS^T Q for the slab, in registers for the
//      whole loop;
//   4. dQ = dS K for the slab, added into the f32 accumulator by vector
//      reductions; the next Q tile's first chunk is copied meanwhile.
// A thread owns keys ty + 16 i and rows tx + 16 j of S and dP, keys
// ty + 16 i and columns 4 tx .. + 3 of dK and dV, and rows 4 ty .. + 3 and
// columns 4 tx .. + 3 of dQ.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_ffma_kernel(Args a) {
  constexpr int BM = kFfmaBM, BN = kFfmaBN, CW = kFfmaBwdSlab;
  constexpr int LD = CW + 4;     // chunk rows: 4 words apart mod 32 banks
  constexpr int LDT = BM + 16;   // P^T/dS^T rows: a warp's two on other banks
  static_assert(BM == 64 && BN == 64 && CW == 64, "the 16 x 16 thread grid");
  extern __shared__ __align__(16) float fsm[];
  float* sq = fsm;
  float* sdo = sq + BM * LD;
  float* sk = sdo + BM * LD;
  float* sv = sk + BN * LD;
  float* spt = sv + BN * LD;     // P^T: BN x LDT
  float* sdst = spt + BN * LDT;  // dS^T

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, S = a.S;
  const int k0 = blockIdx.y * BN;
  const int z = blockIdx.z, nc = gridDim.z;  // the slab; chunks = slabs
  const T* qb = static_cast<const T*>(a.q) + b * a.vq.sb + h * a.vq.sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.vdo.sb + h * a.vdo.sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.vk.sb + h * a.vk.sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vv.sb + h * a.vv.sh;
  const float* lse_b = a.lse + (int64_t)bh * S;
  const float* dl_b = a.dl + (int64_t)bh * S;
  float* dqa = a.dq_acc + (int64_t)bh * S * a.acc_w + z * CW;

  const int nq = (S + BM - 1) / BM;
  int i_start = 0;
  if (a.causal) {
    // the first Q tile with a row r that sees column k0: r + offset >= k0
    const int first_row = k0 - a.offset;
    i_start = first_row <= 0 ? 0 : min(nq, first_row / BM);
  }
  const int cfirst = (z + 1) % nc;  // chunk order: z + 1, ..., z
  auto load_qdo = [&](int q0, int c) {
    load_f32_tile<T, BM, CW>(sq, LD, qb, a.vq.ss, q0, S, c * CW, a.d, a.vec);
    load_f32_tile<T, BM, CW>(sdo, LD, dob, a.vdo.ss, q0, S, c * CW, a.d,
                             a.vec);
  };
  auto load_kv = [&](int c) {
    load_f32_tile<T, BN, CW>(sk, LD, kb, a.vk.ss, k0, S, c * CW, a.d, a.vec);
    load_f32_tile<T, BN, CW>(sv, LD, vb, a.vv.ss, k0, S, c * CW, a.d, a.vec);
  };
  if (i_start < nq) {
    load_qdo(i_start * BM, cfirst);
    load_kv(cfirst);
  }
  cp_async_commit();

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float cl = a.scale * kLog2e;
  float dk[4][4], dv[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;

  for (int qi = i_start; qi < nq; ++qi) {
    const int q0 = qi * BM;
    // 1. S and dP, [key i][row j]
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int st = 0; st < nc; ++st) {
      if (st > 0) {
        const int c = (cfirst + st) % nc;
        load_qdo(q0, c);
        load_kv(c);
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncthreads();
      const float* qa = sq + tx * LD;
      const float* ga = sdo + tx * LD;
      const float* ka = sk + ty * LD;
      const float* va = sv + ty * LD;
#pragma unroll 4
      for (int kk = 0; kk < CW; kk += 4) {
        {
          float4 x[4], y[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            x[j] = *reinterpret_cast<const float4*>(qa + 16 * j * LD + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            y[i] = *reinterpret_cast<const float4*>(ka + 16 * i * LD + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sc[i][j] = fmaf(y[i].x, x[j].x, sc[i][j]);
              sc[i][j] = fmaf(y[i].y, x[j].y, sc[i][j]);
              sc[i][j] = fmaf(y[i].z, x[j].z, sc[i][j]);
              sc[i][j] = fmaf(y[i].w, x[j].w, sc[i][j]);
            }
        }
        {
          float4 x[4], y[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            x[j] = *reinterpret_cast<const float4*>(ga + 16 * j * LD + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            y[i] = *reinterpret_cast<const float4*>(va + 16 * i * LD + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dp[i][j] = fmaf(y[i].x, x[j].x, dp[i][j]);
              dp[i][j] = fmaf(y[i].y, x[j].y, dp[i][j]);
              dp[i][j] = fmaf(y[i].z, x[j].z, dp[i][j]);
              dp[i][j] = fmaf(y[i].w, x[j].w, dp[i][j]);
            }
        }
      }
      if (st + 1 < nc) __syncthreads();  // before the next chunk's copies
    }

    // 2. P = exp(S * scale - lse) and dS = P * (dP - dl) * scale. Tiles
    // that need the mask clamp the exponent at 0 and zero the rows whose
    // lse is -1e30 (the reference's :268-277)
    {
      const bool masked = (a.causal && k0 + BN - 1 > q0 + a.offset) ||
                          k0 + BN > S || q0 + BM > S;
      float lr[4], dlr[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + tx + 16 * j;
        lr[j] = row < S ? lse_b[row] : kNegInf;
        dlr[j] = row < S ? dl_b[row] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + tx + 16 * j;
          const float x = sc[i][j] * cl - lr[j] * kLog2e;
          float p;
          if (!masked) {
            p = exp2f(x);  // every pair visible, so the row's lse is finite
          } else {
            const bool vis = row < S && key < S &&
                             (!a.causal || row + a.offset >= key) &&
                             lr[j] > 0.5f * kNegInf;
            p = vis ? exp2f(fminf(x, 0.f)) : 0.f;
          }
          const int at = (ty + 16 * i) * LDT + tx + 16 * j;
          spt[at] = round_to<T>(p);
          sdst[at] = round_to<T>(p * (dp[i][j] - dlr[j]) * a.scale);
        }
      }
    }
    __syncthreads();

    // 3. dV += P^T dO and dK += dS^T Q for the slab
    {
      const float* pa = spt + ty * LDT;
      const float* da = sdst + ty * LDT;
#pragma unroll 2
      for (int r = 0; r < BM; r += 4) {
        float4 pp[4], dd[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pp[i] = *reinterpret_cast<const float4*>(pa + 16 * i * LDT + r);
          dd[i] = *reinterpret_cast<const float4*>(da + 16 * i * LDT + r);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 g4 =
              *reinterpret_cast<const float4*>(sdo + (r + e) * LD + 4 * tx);
          const float4 q4 =
              *reinterpret_cast<const float4*>(sq + (r + e) * LD + 4 * tx);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float pe = comp(pp[i], e), de = comp(dd[i], e);
            dv[i][0] = fmaf(pe, g4.x, dv[i][0]);
            dv[i][1] = fmaf(pe, g4.y, dv[i][1]);
            dv[i][2] = fmaf(pe, g4.z, dv[i][2]);
            dv[i][3] = fmaf(pe, g4.w, dv[i][3]);
            dk[i][0] = fmaf(de, q4.x, dk[i][0]);
            dk[i][1] = fmaf(de, q4.y, dk[i][1]);
            dk[i][2] = fmaf(de, q4.z, dk[i][2]);
            dk[i][3] = fmaf(de, q4.w, dk[i][3]);
          }
        }
      }
    }
    __syncthreads();  // Q and dO are read; the next tile's may come in
    if (qi + 1 < nq) {
      load_qdo(q0 + BM, cfirst);
      cp_async_commit();
    }

    // 4. dQ += dS K for the slab, rows 4 ty .. + 3 (the fixed-order
    // variant leaves dQ to flash_bwd_dq_ordered_kernel)
    if (!a.det) {
      float dq[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;
      const float* da = sdst + 4 * ty;
#pragma unroll 4
      for (int kk = 0; kk < BN; ++kk) {
        const float4 d4 = *reinterpret_cast<const float4*>(da + kk * LDT);
        const float4 k4 =
            *reinterpret_cast<const float4*>(sk + kk * LD + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float de = comp(d4, i);
          dq[i][0] = fmaf(de, k4.x, dq[i][0]);
          dq[i][1] = fmaf(de, k4.y, dq[i][1]);
          dq[i][2] = fmaf(de, k4.z, dq[i][2]);
          dq[i][3] = fmaf(de, k4.w, dq[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = q0 + 4 * ty + i;
        if (row < S) {
          float* p = dqa + (int64_t)row * a.acc_w + 4 * tx;
          red_add2(p, dq[i][0], dq[i][1]);
          red_add2(p + 2, dq[i][2], dq[i][3]);
        }
      }
    }
    if (nc > 1 && qi + 1 < nq) {
      __syncthreads();  // K is read; the next tile's first chunk may come
      load_kv(cfirst);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

  // dK and dV of the slab
  T* dkb = static_cast<T*>(a.dk) + b * a.vdk.sb + h * a.vdk.sh;
  T* dvb = static_cast<T*>(a.dv) + b * a.vdv.sb + h * a.vdv.sh;
  const int col = z * CW + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key < S && col < a.d) {
      store4<T>(dkb + (int64_t)key * a.vdk.ss + col,
                make_float4(dk[i][0], dk[i][1], dk[i][2], dk[i][3]),
                a.d - col, a.vec);
      store4<T>(dvb + (int64_t)key * a.vdv.ss + col,
                make_float4(dv[i][0], dv[i][1], dv[i][2], dv[i][3]),
                a.d - col, a.vec);
    }
  }
}

// The fixed-order dQ: one block of 256 threads per (64-row Q tile,
// batch*head, 64-column slab). The block walks the key tiles that its rows
// see, in key order; per key tile:
//   1. S = Q K^T and dP = dO V^T over the whole head dim, in chunks of 64
//      columns, the block's own slab last, so that K's slab stays for 3
//      (with one chunk, Q and dO are loaded once for all key tiles);
//   2. dS = P * (dP - dl) * scale, rounded to the input type, to shared
//      memory transposed (key-major), exactly as the main pass forms it;
//   3. dQ += dS K for the slab, in registers: each element one fmaf chain
//      over the keys in order.
// A thread owns keys ty + 16 i and rows tx + 16 j of S and dP, and rows
// 4 ty .. + 3 and columns 4 tx .. + 3 of dQ. Rows past S are not stored;
// a row that sees no key gets 0.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
flash_bwd_dq_ordered_kernel(Args a) {
  constexpr int BM = kFfmaBM, BN = kFfmaBN, CW = kFfmaBwdSlab;
  constexpr int LD = CW + 4;
  constexpr int LDT = BM + 16;
  static_assert(BM == 64 && BN == 64 && CW == 64, "the 16 x 16 thread grid");
  extern __shared__ __align__(16) float fsm[];
  float* sq = fsm;
  float* sdo = sq + BM * LD;
  float* sk = sdo + BM * LD;
  float* sv = sk + BN * LD;
  float* sdst = sv + BN * LD;  // dS^T: BN x LDT

  const int bh = blockIdx.x, b = bh / a.H, h = bh % a.H, S = a.S;
  const int q0 = blockIdx.y * BM;
  const int z = blockIdx.z, nc = gridDim.z;
  const T* qb = static_cast<const T*>(a.q) + b * a.vq.sb + h * a.vq.sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.vdo.sb + h * a.vdo.sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.vk.sb + h * a.vk.sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vv.sb + h * a.vv.sh;
  const float* lse_b = a.lse + (int64_t)bh * S;
  const float* dl_b = a.dl + (int64_t)bh * S;

  int nk = (S + BN - 1) / BN;
  if (a.causal) {
    // the last key a row of the tile sees: row + offset >= key
    const int last = min(S - 1, min(q0 + BM - 1, S - 1) + a.offset);
    nk = last < 0 ? 0 : min(nk, last / BN + 1);
  }
  const int cfirst = (z + 1) % nc;  // chunk order: z + 1, ..., z

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const float cl = a.scale * kLog2e;
  float lr[4], dlr[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int row = q0 + tx + 16 * j;
    lr[j] = row < S ? lse_b[row] : kNegInf;
    dlr[j] = row < S ? dl_b[row] : 0.f;
  }
  float dq[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[i][e] = 0.f;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BN;
    // 1. S and dP, [key i][row j]
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int st = 0; st < nc; ++st) {
      const int c = (cfirst + st) % nc;
      if (nc > 1 || kt == 0) {
        load_f32_tile<T, BM, CW>(sq, LD, qb, a.vq.ss, q0, S, c * CW, a.d,
                                 a.vec);
        load_f32_tile<T, BM, CW>(sdo, LD, dob, a.vdo.ss, q0, S, c * CW, a.d,
                                 a.vec);
      }
      load_f32_tile<T, BN, CW>(sk, LD, kb, a.vk.ss, k0, S, c * CW, a.d,
                               a.vec);
      load_f32_tile<T, BN, CW>(sv, LD, vb, a.vv.ss, k0, S, c * CW, a.d,
                               a.vec);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      const float* qa = sq + tx * LD;
      const float* ga = sdo + tx * LD;
      const float* ka = sk + ty * LD;
      const float* va = sv + ty * LD;
#pragma unroll 4
      for (int kk = 0; kk < CW; kk += 4) {
        {
          float4 x[4], y[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            x[j] = *reinterpret_cast<const float4*>(qa + 16 * j * LD + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            y[i] = *reinterpret_cast<const float4*>(ka + 16 * i * LD + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              sc[i][j] = fmaf(y[i].x, x[j].x, sc[i][j]);
              sc[i][j] = fmaf(y[i].y, x[j].y, sc[i][j]);
              sc[i][j] = fmaf(y[i].z, x[j].z, sc[i][j]);
              sc[i][j] = fmaf(y[i].w, x[j].w, sc[i][j]);
            }
        }
        {
          float4 x[4], y[4];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            x[j] = *reinterpret_cast<const float4*>(ga + 16 * j * LD + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
            y[i] = *reinterpret_cast<const float4*>(va + 16 * i * LD + kk);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              dp[i][j] = fmaf(y[i].x, x[j].x, dp[i][j]);
              dp[i][j] = fmaf(y[i].y, x[j].y, dp[i][j]);
              dp[i][j] = fmaf(y[i].z, x[j].z, dp[i][j]);
              dp[i][j] = fmaf(y[i].w, x[j].w, dp[i][j]);
            }
        }
      }
      if (st + 1 < nc) __syncthreads();  // before the next chunk's copies
    }

    // 2. dS = P * (dP - dl) * scale, the main pass's masking
    {
      const bool masked = (a.causal && k0 + BN - 1 > q0 + a.offset) ||
                          k0 + BN > S || q0 + BM > S;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int row = q0 + tx + 16 * j;
          const float x = sc[i][j] * cl - lr[j] * kLog2e;
          float p;
          if (!masked) {
            p = exp2f(x);
          } else {
            const bool vis = row < S && key < S &&
                             (!a.causal || row + a.offset >= key) &&
                             lr[j] > 0.5f * kNegInf;
            p = vis ? exp2f(fminf(x, 0.f)) : 0.f;
          }
          sdst[(ty + 16 * i) * LDT + tx + 16 * j] =
              round_to<T>(p * (dp[i][j] - dlr[j]) * a.scale);
        }
      }
    }
    __syncthreads();

    // 3. dQ += dS K for the slab, keys in order
    {
      const float* da = sdst + 4 * ty;
#pragma unroll 4
      for (int kk = 0; kk < BN; ++kk) {
        const float4 d4 = *reinterpret_cast<const float4*>(da + kk * LDT);
        const float4 k4 =
            *reinterpret_cast<const float4*>(sk + kk * LD + 4 * tx);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float de = comp(d4, i);
          dq[i][0] = fmaf(de, k4.x, dq[i][0]);
          dq[i][1] = fmaf(de, k4.y, dq[i][1]);
          dq[i][2] = fmaf(de, k4.z, dq[i][2]);
          dq[i][3] = fmaf(de, k4.w, dq[i][3]);
        }
      }
    }
    __syncthreads();  // K and dS^T are read; the next tile's may come in
  }
  cp_async_wait<0>();

  T* dqb = static_cast<T*>(a.dq) + b * a.vdq.sb + h * a.vdq.sh;
  const int col = z * CW + 4 * tx;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row < S && col < a.d)
      store4<T>(dqb + (int64_t)row * a.vdq.ss + col,
                make_float4(dq[i][0], dq[i][1], dq[i][2], dq[i][3]),
                a.d - col, a.vec);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

// Blocks of the preprocess and convert kernels: D / 8 threads per row.
inline dim3 row_grid(const Args& a, int D) {
  const int64_t threads = (int64_t)a.B * a.H * a.S * (D / 8);
  return dim3((unsigned)((threads + kThreads - 1) / kThreads));
}

// The three kernels of the FFMA pass: rows (dl, zeroed accumulator), the
// main pass on slabs of kFfmaBwdSlab columns, the dQ store; with `det`,
// rows (dl only), the main pass without its dQ reductions and the
// fixed-order dQ kernel.
template <typename T>
cudaError_t launch_ffma(const Args& a, cudaStream_t stream) {
  if (a.dq_acc == nullptr && !a.det) return cudaErrorInvalidValue;
  auto fn = flash_bwd_ffma_kernel<T>;
  const size_t bytes =
      sizeof(float) * (4 * 64 * (kFfmaBwdSlab + 4) + 2 * 64 * (kFfmaBM + 16));
  const int tiles = (a.S + kFfmaBN - 1) / kFfmaBN;
  const int slabs = a.acc_w / kFfmaBwdSlab;
  if (tiles > 65535 || slabs > 65535) return cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const int64_t rows = (int64_t)a.B * a.H * a.S;
  flash_bwd_rows_kernel<T><<<(unsigned)((rows + 7) / 8), kThreads, 0,
                              stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fn<<<dim3(a.B * a.H, tiles, slabs), kThreads, bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (a.det) {
    auto dqfn = flash_bwd_dq_ordered_kernel<T>;
    const size_t dq_bytes =
        sizeof(float) * (4 * 64 * (kFfmaBwdSlab + 4) + 64 * (kFfmaBM + 16));
    err = cudaFuncSetAttribute(
        dqfn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_bytes);
    if (err != cudaSuccess) return err;
    const int qtiles = (a.S + kFfmaBM - 1) / kFfmaBM;
    dqfn<<<dim3(a.B * a.H, qtiles, slabs), kThreads, dq_bytes, stream>>>(a);
    return cudaGetLastError();
  }
  const int64_t threads = rows * ((a.d + 3) / 4);
  flash_bwd_dq_store_kernel<T><<<(unsigned)((threads + kThreads - 1) /
                                            kThreads),
                                 kThreads, 0, stream>>>(a);
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
// for dl): contiguous (B, H, S) float32. D is the head dim, any D >= 1:
// f32, and bf16/f16 above 256, run the FFMA pass; bf16/f16 to 256 the
// tensor-core kernels built for the next of 16, 32, 64, 128 and 256.
// dq_acc: contiguous (B, H, S, W) float32 scratch, W that padded D for the
// tensor-core kernels and D rounded up to whole slabs of 64 for the FFMA
// pass. det (FFMA route only; the 16-bit kernels refuse it): dQ summed in
// key-tile order by the fixed-order kernel, dq_acc unused (may be null).
// Launches every kernel on `stream`; returns the first cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* out,
                                   const void* dout, const float* lse,
                                   const float* g_lse, float* dl,
                                   float* dq_acc, void* dq, void* dk,
                                   void* dv, int dtype, int B, int H, int S,
                                   int D, const long long* strides,
                                   int causal, int offset, float scale,
                                   int det, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0 || D <= 0 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  const bool ffma = ffma_route(dtype, D);
  if (det && !ffma) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, out, dout, lse, g_lse, dl, dq_acc, dq, dk, dv,
         view(strides), view(strides + 3), view(strides + 6),
         view(strides + 9), view(strides + 12), view(strides + 15),
         view(strides + 18), view(strides + 21),
         B, H, S, D, causal, offset, scale, true,
         ffma ? (D + kFfmaBwdSlab - 1) / kFfmaBwdSlab * kFfmaBwdSlab
              : padded_dim(D),
         det ? 1 : 0};
  const void* ptrs[8] = {q, k, v, out, dout, dq, dk, dv};
  const View views[8] = {a.vq, a.vk, a.vv, a.vo, a.vdo, a.vdq, a.vdk, a.vdv};
  for (int i = 0; i < 8; ++i)
    a.vec = a.vec && vec_ok(ptrs[i], views[i], dtype == 0 ? 4 : 2);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ffma) {
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
  if (!nargs(n, 23, "flash_attention_bwd")) return nullptr;
  const void *q = ptr(a[0]), *k = ptr(a[1]), *v = ptr(a[2]),
             *out = ptr(a[3]), *dout = ptr(a[4]);
  const float* lse = static_cast<const float*>(ptr(a[5]));
  const float* g_lse = static_cast<const float*>(ptr(a[6]));
  float* dl = static_cast<float*>(ptr(a[7]));
  float* dq_acc = static_cast<float*>(ptr(a[8]));
  void *dq = ptr(a[9]), *dk = ptr(a[10]), *dv = ptr(a[11]);
  const int dtype = i32(a[12]), B = i32(a[13]), H = i32(a[14]),
            S = i32(a[15]), D = i32(a[16]);
  long long strides[24];
  if (!i64s(a[17], strides, 24)) return nullptr;
  const int causal = i32(a[18]), offset = i32(a[19]);
  const float scale = f32(a[20]);
  const int det = i32(a[21]);
  void* stream = ptr(a[22]);
  if (PyErr_Occurred()) return nullptr;
  int err;
  Py_BEGIN_ALLOW_THREADS
  err = flash_attention_bwd(q, k, v, out, dout, lse, g_lse, dl, dq_acc, dq,
                            dk, dv, dtype, B, H, S, D, strides, causal,
                            offset, scale, det, stream);
  Py_END_ALLOW_THREADS
  return PyLong_FromLong(err);
}

}  // namespace

MXT_PY_MODULE(flash_attention_bwd, py_launch)
