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
// of the Q tile sees are never visited; tiles that every row sees fully
// run without the mask test. A row that sees no column gets out 0 and
// lse -1e30 (the reference's :133-139).
//
// What bounds it: operations. At the model's shapes (B 4, H 12, S 2048,
// D 64, causal) the visible pairs are 48 * 2048 * 2049 / 2 = 1.007e8, so
// 4 * D * pairs = 25.8 GFLOP against 50.7 MB of HBM traffic in bf16: 26 us
// at the tensor cores' 989 TFLOP/s, 15 us at 3.35 TB/s. In f32 the
// 67 TFLOP/s of FFMA make it 385 us.
//
// Design (simple and right first; wgmma, TMA and pipelining come later):
//   - one block per (Q tile of 64 rows, batch*head); the Q tile stays in
//     shared memory while the block loops over the K/V tiles of its row,
//     which takes the place of the TPU's sequential grid axis;
//   - Q K^T and P V are tile products in shared memory (mm() in
//     flash_common.cuh: WMMA for bf16/f16, FFMA for f32);
//   - four threads own one row: they reduce its max and sum with two warp
//     shuffles and write P (rounded to the input type, as the reference
//     casts p to v's dtype) for the P V product; the output accumulator
//     stays in registers, f32;
//   - causal blocks are scheduled heaviest first (the last Q tiles see the
//     most K tiles);
//   - q/k/v and out are read and written through element strides with a
//     contiguous last dimension: the model's q/k/v are transposed views of
//     its fused QKV projection and need no copy. Tiles load 16 bytes per
//     thread where the rows are 16-byte aligned (the model's are);
//   - 16-bit kernels are capped at 128 registers a thread so that two
//     blocks share an SM and one's loads overlap the other's products
//     (measured on the H100: 1.5x over one block per SM with scalar loads).

#include "flash_common.cuh"

namespace {

using namespace mxt_flash;

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, int H, int S, View vq, View vk,
                 View vv, View vo, int causal, int offset, float scale,
                 bool vec) {
  using L = Smem<T, D>;
  constexpr int kLdT = L::kLdT, kLdP = L::kLdP, kLdF = L::kLdF;
  constexpr int kAcc = kBQ * D / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = at<T>(smem, L::kA);
  T* sk = at<T>(smem, L::kB);
  T* sv = at<T>(smem, L::kC);
  T* sp = at<T>(smem, L::kP);
  float* sf = at<float>(smem, L::kF);
  float* s_alpha = at<float>(smem, L::kRow0);  // later: row max
  float* s_l = at<float>(smem, L::kRow1);

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const T* qb = q + b * vq.sb + h * vq.sh;
  const T* kb = k + b * vk.sb + h * vk.sh;
  const T* vb = v + b * vv.sb + h * vv.sh;
  T* ob = out + b * vo.sb + h * vo.sh;
  load_tile<T, D, kLdT>(sq, qb, vq.ss, q0, S, vec);

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
    load_tile<T, D, kLdT>(sk, kb, vk.ss, k0, S, vec);
    load_tile<T, D, kLdT>(sv, vb, vv.ss, k0, S, vec);
    __syncthreads();
    mm<T, true, false, kBQ, kBK, D>(sf, kLdF, sq, kLdT, sk, kLdT);  // Q K^T
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
      sp[row * kLdP + part + 4 * i] = from_f32<T>(p);
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * alpha + sum;
    m = mn;
    if (part == 0) s_alpha[row] = alpha;
    __syncthreads();
    mm<T, true, true, kBQ, D, kBK>(sf, kLdF, sp, kLdP, sv, kLdT);  // P V
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
      ob[(int64_t)qr * vo.ss + d] = from_f32<T>(lr > 0.f ? acc[e] / lr : 0.f);
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

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   float* lse, int B, int H, int S, const long long* st,
                   int causal, int offset, float scale, cudaStream_t stream) {
  using L = Smem<T, D>;
  auto fn = flash_fwd_kernel<T, D>;
  cudaError_t err = prepare(fn, L::kBytes, B, H);
  if (err != cudaSuccess) return err;
  const bool vec = vec_ok(q, view(st), sizeof(T)) &&
                   vec_ok(k, view(st + 3), sizeof(T)) &&
                   vec_ok(v, view(st + 6), sizeof(T));
  const dim3 grid((S + kBQ - 1) / kBQ, B * H);
  fn<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), lse, H, S, view(st),
      view(st + 3), view(st + 6), view(st + 9), causal, offset, scale, vec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const void* q, const void* k, const void* v,
                       void* out, float* lse, int B, int H, int S,
                       const long long* st, int causal, int offset,
                       float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, lse, B, H, S, st, causal, offset,
                           scale, stream);
    case 32:
      return launch<T, 32>(q, k, v, out, lse, B, H, S, st, causal, offset,
                           scale, stream);
    case 64:
      return launch<T, 64>(q, k, v, out, lse, B, H, S, st, causal, offset,
                           scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, lse, B, H, S, st, causal, offset,
                            scale, stream);
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_dim<float>(D, q, k, v, out, lse, B, H, S, strides,
                                    causal, offset, scale, st);
    case 1:
      return (int)launch_dim<__nv_bfloat16>(D, q, k, v, out, lse, B, H, S,
                                            strides, causal, offset, scale,
                                            st);
    case 2:
      return (int)launch_dim<__half>(D, q, k, v, out, lse, B, H, S, strides,
                                     causal, offset, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
