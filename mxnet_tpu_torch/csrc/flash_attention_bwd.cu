// Flash-attention backward for Hopper (sm_90a), plain C entry point bound
// with ctypes by mxnet_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas kernel _bwd_kernel of
// mxnet_tpu/ops/flash_attention.py:298 (launched by _bwd_pallas, :324; the
// math is _bwd_core, :230). Same function: given q, k, v, dO, the forward's
// lse and dl = delta - dlse (delta = rowsum(dO * O), computed by the
// caller as the reference does outside its kernel, :333-334), it
// recomputes P = exp(Q K^T * scale - lse) and forms
//   dV = P^T dO,   dS = P * (dO V^T - dl) * scale,   dK = dS^T Q,
//   dQ = dS K.
// P and dS are rounded to the input type before their products, as the
// reference casts them. Tiles that need the mask clamp the exponent at 0
// and zero the rows whose lse is -1e30 (rows that see nothing, :268-277):
// without that, exp2 of (-1e30 - -1e30)-sized terms would give inf and
// NaN gradients for negative offsets.
//
// The Pallas kernel accumulates dQ across its K/V grid steps in one
// resident output block, which works only because the TPU grid runs in
// order (:236-237, :305-307). Blocks on the card run concurrently, so the
// accumulation is split into two passes, deterministic and free of
// atomics:
//   1. dK/dV: one block per (K tile, batch*head) keeps its K/V tile and
//      its dK/dV accumulators resident and loops over the Q tiles that see
//      it (the loop of _bwd_core);
//   2. dQ: one block per (Q tile, batch*head) keeps Q, dO, lse and dl
//      resident and loops over the K tiles its rows see, recomputing P and
//      dS, with dQ accumulated in f32 registers.
// P and dS are computed twice, so the kernels do 7 tile products where 5
// are needed. Each tile step computes S and dP into two f32 scratch tiles,
// then P and dS in one element-wise pass (no per-thread state carried
// across the products), then the products that consume them.
//
// What bounds it: operations. At the model's shapes (B 4, H 12, S 2048,
// D 64, causal, 1.007e8 visible pairs) the minimal work is
// 10 * D * pairs = 64.5 GFLOP, 65 us at 989 TFLOP/s in bf16, against
// about 101 MB of HBM traffic (30 us at 3.35 TB/s).
//
// Tile products, shared-memory layout and type handling are those of the
// forward (flash_common.cuh): WMMA with f32 accumulation for bf16/f16,
// FFMA for f32. All tensors but lse and dl are read or written through
// element strides with a contiguous last dimension.

#include "flash_common.cuh"

namespace {

using namespace mxt_flash;

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *dl;
  void *dq, *dk, *dv;
  View vq, vk, vv, vdo, vdq, vdk, vdv;
  int H, S, causal, offset;
  float scale;
  bool vec;  // every q/k/v/dout row starts on a 16-byte boundary
};

constexpr int kElems = kBQ * kBK / kThreads;  // score elements per thread

// From the scores S (in sf) and dP = dO V^T (in sg) of the (q0, k0) tile:
// P = exp(S * scale - lse) into sp (skipped when null) and
// dS = P * (dP - dl) * scale into sds, both rounded to the input type.
template <typename T, int kLdF, int kLdP>
__device__ __forceinline__ void probs_dscores(T* sp, T* sds, const float* sf,
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
    if (sp != nullptr) sp[r * kLdP + cc] = from_f32<T>(p);
    sds[r * kLdP + cc] =
        from_f32<T>(p * (sg[r * kLdF + cc] - s_dl[r]) * a.scale);
  }
}

// lse and dl of rows row0 .. row0+63 (rows past S: -1e30 and 0).
__device__ __forceinline__ void load_rows(float* s_lse, float* s_dl,
                                          const float* lse, const float* dl,
                                          int64_t base, int row0, int S) {
  if (threadIdx.x < 64) {
    const int s = row0 + threadIdx.x;
    s_lse[threadIdx.x] = s < S ? lse[base + s] : kNegInf;
    s_dl[threadIdx.x] = s < S ? dl[base + s] : 0.f;
  }
}

template <typename T, int D>
__device__ __forceinline__ void store_tile(T* dst, int64_t ss, const float* acc,
                                           int row0, int S) {
  constexpr int kAcc = 64 * D / kThreads;
#pragma unroll
  for (int e = 0; e < kAcc; ++e) {
    const int idx = threadIdx.x + e * kThreads;
    const int r = idx / D, d = idx % D;
    if (row0 + r < S) dst[(int64_t)(row0 + r) * ss + d] = from_f32<T>(acc[e]);
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
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
flash_bwd_dkdv_kernel(Args a) {
  using L = Smem<T, D>;
  constexpr int kLdT = L::kLdT, kLdP = L::kLdP, kLdF = L::kLdF;
  constexpr int kAcc = 64 * D / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = at<T>(smem, L::kA);
  T* sdo = at<T>(smem, L::kB);
  T* sk = at<T>(smem, L::kC);
  T* sv = at<T>(smem, L::kD);
  T* sp = at<T>(smem, L::kP);
  T* sds = at<T>(smem, L::kDS);
  float* sf = at<float>(smem, L::kF);
  float* sg = at<float>(smem, L::kG);
  float* s_lse = at<float>(smem, L::kRow0);
  float* s_dl = at<float>(smem, L::kRow1);

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const int k0 = blockIdx.x * kBK;  // the first K tiles see the most rows
  const T* qb = static_cast<const T*>(a.q) + b * a.vq.sb + h * a.vq.sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.vdo.sb + h * a.vdo.sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.vk.sb + h * a.vk.sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vv.sb + h * a.vv.sh;
  load_tile<T, D, kLdT>(sk, kb, a.vk.ss, k0, S, a.vec);
  load_tile<T, D, kLdT>(sv, vb, a.vv.ss, k0, S, a.vec);

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
    load_tile<T, D, kLdT>(sq, qb, a.vq.ss, q0, S, a.vec);
    load_tile<T, D, kLdT>(sdo, dob, a.vdo.ss, q0, S, a.vec);
    load_rows(s_lse, s_dl, a.lse, a.dl, (int64_t)bh * S, q0, S);
    __syncthreads();
    mm<T, true, false, kBQ, kBK, D>(sf, kLdF, sq, kLdT, sk, kLdT);  // Q K^T
    mm<T, true, false, kBQ, kBK, D>(sg, kLdF, sdo, kLdT, sv, kLdT);  // dO V^T
    __syncthreads();
    probs_dscores<T, kLdF, kLdP>(sp, sds, sf, sg, s_lse, s_dl, q0, k0, a);
    __syncthreads();
    mm<T, false, true, kBK, D, kBQ>(sf, kLdF, sp, kLdP, sdo, kLdT);  // P^T dO
    mm<T, false, true, kBK, D, kBQ>(sg, kLdF, sds, kLdP, sq, kLdT);  // dS^T Q
    __syncthreads();
    accumulate<D, kLdF>(dv, sf);
    accumulate<D, kLdF>(dk, sg);
  }
  T* dkb = static_cast<T*>(a.dk) + b * a.vdk.sb + h * a.vdk.sh;
  T* dvb = static_cast<T*>(a.dv) + b * a.vdv.sb + h * a.vdv.sh;
  store_tile<T, D>(dkb, a.vdk.ss, dk, k0, S);
  store_tile<T, D>(dvb, a.vdv.ss, dv, k0, S);
}

// Pass 2: dQ of one Q tile. Per K tile: S and dP, then dS, then dS K.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks<T>)
flash_bwd_dq_kernel(Args a) {
  using L = Smem<T, D>;
  constexpr int kLdT = L::kLdT, kLdP = L::kLdP, kLdF = L::kLdF;
  constexpr int kAcc = 64 * D / kThreads;
  extern __shared__ __align__(128) unsigned char smem[];
  T* sq = at<T>(smem, L::kA);
  T* sdo = at<T>(smem, L::kB);
  T* sk = at<T>(smem, L::kC);
  T* sv = at<T>(smem, L::kD);
  T* sds = at<T>(smem, L::kDS);
  float* sf = at<float>(smem, L::kF);
  float* sg = at<float>(smem, L::kG);
  float* s_lse = at<float>(smem, L::kRow0);
  float* s_dl = at<float>(smem, L::kRow1);

  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H, S = a.S;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // heaviest first
  const T* qb = static_cast<const T*>(a.q) + b * a.vq.sb + h * a.vq.sh;
  const T* dob = static_cast<const T*>(a.dout) + b * a.vdo.sb + h * a.vdo.sh;
  const T* kb = static_cast<const T*>(a.k) + b * a.vk.sb + h * a.vk.sh;
  const T* vb = static_cast<const T*>(a.v) + b * a.vv.sb + h * a.vv.sh;
  load_tile<T, D, kLdT>(sq, qb, a.vq.ss, q0, S, a.vec);
  load_tile<T, D, kLdT>(sdo, dob, a.vdo.ss, q0, S, a.vec);
  load_rows(s_lse, s_dl, a.lse, a.dl, (int64_t)bh * S, q0, S);

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
    load_tile<T, D, kLdT>(sk, kb, a.vk.ss, k0, S, a.vec);
    load_tile<T, D, kLdT>(sv, vb, a.vv.ss, k0, S, a.vec);
    __syncthreads();
    mm<T, true, false, kBQ, kBK, D>(sf, kLdF, sq, kLdT, sk, kLdT);  // Q K^T
    mm<T, true, false, kBQ, kBK, D>(sg, kLdF, sdo, kLdT, sv, kLdT);  // dO V^T
    __syncthreads();
    probs_dscores<T, kLdF, kLdP>(static_cast<T*>(nullptr), sds, sf, sg,
                                 s_lse, s_dl, q0, k0, a);
    __syncthreads();
    mm<T, true, true, kBQ, D, kBK>(sf, kLdF, sds, kLdP, sk, kLdT);  // dS K
    __syncthreads();
    accumulate<D, kLdF>(dq, sf);
  }
  T* dqb = static_cast<T*>(a.dq) + b * a.vdq.sb + h * a.vdq.sh;
  store_tile<T, D>(dqb, a.vdq.ss, dq, q0, S);
}

template <typename T, int D>
cudaError_t launch(const Args& a, int B, cudaStream_t stream) {
  using L = Smem<T, D>;
  auto dkdv = flash_bwd_dkdv_kernel<T, D>;
  auto dq = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = prepare(dkdv, L::kBytes, B, a.H);
  if (err == cudaSuccess) err = prepare(dq, L::kBytes, B, a.H);
  if (err != cudaSuccess) return err;
  const dim3 grid_k((a.S + kBK - 1) / kBK, B * a.H);
  dkdv<<<grid_k, kThreads, L::kBytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid_q((a.S + kBQ - 1) / kBQ, B * a.H);
  dq<<<grid_q, kThreads, L::kBytes, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dim(int D, const Args& a, int B, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(a, B, stream);
    case 32:
      return launch<T, 32>(a, B, stream);
    case 64:
      return launch<T, 64>(a, B, stream);
    case 128:
      return launch<T, 128>(a, B, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, k, v, dout, dq, dk and
// dv share it). strides: 21 element strides, (b, h, s) of q, k, v, dout,
// dq, dk and dv in that order, each with a contiguous last dimension. lse
// and dl: contiguous (B, H, S) float32. D must be 16, 32, 64 or 128.
// Launches the dK/dV pass, then the dQ pass, on `stream`. Returns the
// first cudaError_t.
extern "C" int flash_attention_bwd(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* dl,
                                   void* dq, void* dk, void* dv, int dtype,
                                   int B, int H, int S, int D,
                                   const long long* strides, int causal,
                                   int offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  Args a{q, k, v, dout, lse, dl, dq, dk, dv,
         view(strides), view(strides + 3), view(strides + 6),
         view(strides + 9), view(strides + 12), view(strides + 15),
         view(strides + 18), H, S, causal, offset, scale, false};
  const int eb = dtype == 0 ? 4 : 2;
  a.vec = vec_ok(q, a.vq, eb) && vec_ok(k, a.vk, eb) && vec_ok(v, a.vv, eb) &&
          vec_ok(dout, a.vdo, eb);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_dim<float>(D, a, B, st);
    case 1:
      return (int)launch_dim<__nv_bfloat16>(D, a, B, st);
    case 2:
      return (int)launch_dim<__half>(D, a, B, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
