// Flash-attention forward for Hopper (sm_90a), plain C entry point bound
// with ctypes by mxnet_tpu_torch/ops/_kernels.py.
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
//     (D <= 32) or re-read per step (D 128, for registers);
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
// f32 (flash_fwd_kernel) keeps the first design: 64 x 64 tiles in shared
// memory, FFMA products through mm() (the reference's HIGHEST precision),
// four threads per row for the softmax. In f32 the 67 TFLOP/s of FFMA
// bound it at 385 us.

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
                     float* __restrict__ lse, int H, int S, View vq, View vk,
                     View vv, View vo, int causal, int offset, float scale,
                     bool vec) {
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
    load_rows<T, D, kFwdBM, kThreads>(sq, qb, vq.ss, q0, S, vec);
    load_rows<T, D, BN, kThreads>(skv, kb, vk.ss, 0, S, vec);
    load_rows<T, D, BN, kThreads>(skv + BN * D, vb, vv.ss, 0, S, vec);
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
      load_rows<T, D, BN, kThreads>(nxt, kb, vk.ss, (j + 1) * BN, S, vec);
      load_rows<T, D, BN, kThreads>(nxt + BN * D, vb, vv.ss, (j + 1) * BN, S,
                                    vec);
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
  store_rows<T, D, 16>(ob, vo.ss, so, q0 + wq, S, vec, lane, 32);
  if (tq == 0) {
    if (row0 < S)
      lse[(int64_t)bh * S + row0] = l0 > 0.f ? m0 * kLn2 + logf(l0) : kNegInf;
    if (row1 < S)
      lse[(int64_t)bh * S + row1] = l1 > 0.f ? m1 * kLn2 + logf(l1) : kNegInf;
  }
}

// ---------------------------------------------------------------------------
// f32: FFMA kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, int H, int S, View vq, View vk,
                 View vv, View vo, int causal, int offset, float scale) {
  using L = Smem<D>;
  constexpr int kLdT = L::kLdT, kLdP = L::kLdP, kLdF = L::kLdF;
  constexpr int kAcc = kBQ * D / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sq = at<float>(smem, L::kA);
  float* sk = at<float>(smem, L::kB);
  float* sv = at<float>(smem, L::kC);
  float* sp = at<float>(smem, L::kP);
  float* sf = at<float>(smem, L::kF);
  float* s_alpha = at<float>(smem, L::kRow0);  // later: row max
  float* s_l = at<float>(smem, L::kRow1);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const float* qb = q + b * vq.sb + h * vq.sh;
  const float* kb = k + b * vk.sb + h * vk.sh;
  const float* vb = v + b * vv.sb + h * vv.sh;
  float* ob = out + b * vo.sb + h * vo.sh;
  load_tile<D, kLdT>(sq, qb, vq.ss, q0, S);

  const float c = scale * kLog2e;  // raw score -> log2 domain
  const int nk = (S + kBK - 1) / kBK;
  int nk_run = nk;
  if (causal) {
    // the largest column any row of this tile sees
    const int last_col = min(q0 + kBQ, S) - 1 + offset;
    nk_run = last_col < 0 ? 0 : min(nk, last_col / kBK + 1);
  }
  const int row = threadIdx.x >> 2, part = threadIdx.x & 3;
  const int qrow = q0 + row;
  float m = kNegInf, l = 0.f;
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;

  for (int j = 0; j < nk_run; ++j) {
    const int k0 = j * kBK;
    load_tile<D, kLdT>(sk, kb, vk.ss, k0, S);
    load_tile<D, kLdT>(sv, vb, vv.ss, k0, S);
    __syncthreads();
    mm<true, false, kBQ, kBK, D>(sf, kLdF, sq, kLdT, sk, kLdT);  // Q K^T
    __syncthreads();
    // a tile needs the mask only where some pair is hidden or ragged
    const bool masked = (causal && k0 + kBK - 1 > q0 + offset) ||
                        k0 + kBK > S || q0 + kBQ > S;
    float t[kBK / 4];
    float mx = kNegInf;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      const int col = part + 4 * i;
      t[i] = sf[row * kLdF + col] * c;
      if (masked) {
        const int kc = k0 + col;
        if (kc >= S || qrow >= S || (causal && qrow + offset < kc))
          t[i] = kNegInf;
      }
      mx = fmaxf(mx, t[i]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float mn = fmaxf(m, mx);
    const float alpha = exp2f(m - mn);
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 4; ++i) {
      // a hidden pair contributes exactly 0, also while the row has seen
      // nothing yet (mn still -1e30)
      const float p = t[i] > 0.5f * kNegInf ? exp2f(t[i] - mn) : 0.f;
      sum += p;
      sp[row * kLdP + part + 4 * i] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = mn;
    if (part == 0) s_alpha[row] = alpha;
    __syncthreads();
    mm<true, true, kBQ, D, kBK>(sf, kLdF, sp, kLdP, sv, kLdT);  // P V
    __syncthreads();
#pragma unroll
    for (int e = 0; e < kAcc; ++e) {
      const int idx = threadIdx.x + e * kThreads;
      const int r = idx / D, d = idx % D;
      acc[e] = acc[e] * s_alpha[r] + sf[r * kLdF + d];
    }
  }

  __syncthreads();  // s_alpha is read above until the last tile ends
  if (part == 0) {
    s_alpha[row] = m;
    s_l[row] = l;
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / D, d = idx % D;
    const int qr = q0 + r;
    if (qr < S) {
      const float lr = s_l[r];
      // a row with no visible column has l == 0: out 0, never NaN
      ob[(int64_t)qr * vo.ss + d] = lr > 0.f ? acc[e] / lr : 0.f;
    }
  }
  if (threadIdx.x < kBQ) {
    const int r = threadIdx.x, qr = q0 + r;
    if (qr < S) {
      const float lr = s_l[r];
      lse[(int64_t)bh * S + qr] =
          lr > 0.f ? s_alpha[r] * kLn2 + logf(lr) : kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* out;
  float* lse;
  int B, H, S;
  const long long* st;
  int causal, offset;
  float scale;
};

template <int D>
cudaError_t launch_f32(const Args& a, cudaStream_t stream) {
  using L = Smem<D>;
  auto fn = flash_fwd_kernel<D>;
  cudaError_t err = prepare(fn, L::kBytes, a.B, a.H);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + kBQ - 1) / kBQ, a.B * a.H);
  fn<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.out), a.lse, a.H,
      a.S, view(a.st), view(a.st + 3), view(a.st + 6), view(a.st + 9),
      a.causal, a.offset, a.scale);
  return cudaGetLastError();
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
      static_cast<const T*>(a.v), static_cast<T*>(a.out), a.lse, a.H, a.S, vq,
      vk, vv, vo, a.causal, a.offset, a.scale, vec);
  return cudaGetLastError();
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

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v and out share
// it). strides: 12 element strides, (b, h, s) of q, k, v and out, each
// with a contiguous last dimension. lse: contiguous (B, H, S) float32.
// D must be 16, 32, 64 or 128. Returns the cudaError_t of the launch.
extern "C" int flash_attention_fwd(const void* q, const void* k,
                                   const void* v, void* out, float* lse,
                                   int dtype, int B, int H, int S, int D,
                                   const long long* strides, int causal,
                                   int offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, out, lse, B, H, S, strides, causal, offset, scale};
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
