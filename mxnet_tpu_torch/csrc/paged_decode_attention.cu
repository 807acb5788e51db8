// Paged decode attention for Hopper (sm_90a): a plain C launcher and its
// CPython entry point (pyentry.cuh), built and imported by
// mxnet_tpu_torch/ops/_kernels.py.
//
// Replaces the Pallas kernel nested in
// mxnet_tpu/ops/flash_attention.py:559 flash_decode_attention (pallas_call
// :637). Same function: one query position per sequence attends to the
// K/V positions [0, length[b]) that its page table row names, straight
// from the page pool — the attention is the gather. Online softmax in log2
// with f32 statistics, output normalised once at the end with the
// denominator clamped at 1e-30, so a length-0 row writes 0, never NaN.
//
// What bounds it: HBM bytes. Each live K and V row is read once (plus q
// and out); the arithmetic is 4*D flops a position. At the serving path's
// shapes (8 slots, 12 heads of 64, pages of 16, f32 pool) eight full rows
// of 2048 positions are 100.7 MB, 30.0 us at 3.35 TB/s. Reaching that
// takes a few MB in flight across the chip, from every SM.
//
// Design (flash-decoding):
//   - split: a row's positions are cut into chunks of `chunk` positions, a
//     whole number of pages, and each (chunk, head, sequence) is one block
//     of kWarps = 8 warps. The grid comes from the static shapes alone
//     (max_pages * page); the lengths live on the device and are never
//     read by the host. A block whose chunk starts at or past its row's
//     length exits at once. The wrapper picks the chunk from the static
//     shapes and the SM count (ops/flash_attention.py _decode_chunk);
//   - wide loads: a lane loads 16 bytes (4 f32, or 8 bf16/f16) of a K row
//     and of a V row; a row of D elements takes LPR = D / 4 (f32) or D / 8
//     lanes (16 or 8 at D 64), so a warp reads 32 / LPR positions with one
//     load instruction and sums each score over log2(LPR) shuffles. Each
//     lane group keeps kUnroll positions in flight: 32 KB a block in f32 at
//     D 64, and four blocks an SM;
//   - the chunk's page ids are read once into shared memory, before any
//     K/V load, so no load waits on a page-table load;
//   - every lane group keeps its own running max, denominator and
//     accumulator slice; the groups of a warp merge by shuffles and the
//     warps through shared memory, in a fixed order;
//   - a row of length <= chunk has one chunk: its block writes the
//     normalised output directly (a length-0 row writes 0). The blocks of
//     a longer row write their partial (m, l, o[D]), f32 in the log2
//     domain, to a workspace that the wrapper allocates, and
//     paged_decode_merge_kernel, launched right after from the same entry
//     point, combines a row's partials in chunk order. No sum depends on
//     which block finishes first: repeated calls are bitwise equal;
//   - views whose pointers or element strides are not multiples of 16
//     bytes, or whose D is not a multiple of the vector, take element
//     loads (VEC = 1) in the same kernel.
// What this does about the first kernel's limits (one block of 8 warps
// per (sequence, head): 96 blocks on 132 SMs at the smoke's shapes, 24 of
// them moving 84% of the bytes at ragged lengths; 4-byte loads, about 8 KB
// in flight a block; a page-table load and a 5-step warp sum on every
// position's path): long rows now spread over as many blocks as chunks,
// and each lane has 16-byte loads of kUnroll positions in flight.
// Measured alternatives (mxnet_tpu_torch/tools/decode_chunks.py): blocks
// of 4 warps, 8 positions in flight per lane group, the heads of a chunk
// in consecutive blocks; chunks of 64 to 512 positions.
//
// The K/V views are strided slices of the 6-d pool
// (pages, layers, 2, page, heads, head_dim): element strides come from the
// caller, the last dimension must be contiguous, and offsets are 64-bit
// (page id * page stride passes 2^31 elements in a full-size pool).
// Page ids are clamped to [0, num_pages): an out-of-range id reads a wrong
// page instead of faulting, the clamped-gather behaviour of the reference.
// Lengths are clamped to [0, max_pages * page].

#include "pyentry.cuh"

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;            // positions in flight per lane group
constexpr int kMaxD = 256;
constexpr int kMaxChunkPages = 512;   // page ids of one chunk, in shared
constexpr int kMergeThreads = 128;
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const int* table;
  const int* lengths;
  void* out;
  float* ws;  // partials: o[B][H][n_chunks][D], then (m, l)[B][H][n_chunks]
  int B, H, D, page, max_pages, num_pages, chunk, n_chunks;
  int lpr_log2;  // lanes per K/V row = 1 << lpr_log2
  long long q_sb, q_sh, kv_sp, kv_ss, kv_sh;
  float s2_scale;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

__device__ __forceinline__ float2 pair_f32(uint32_t w, __nv_bfloat16) {
  __nv_bfloat162 h;
  memcpy(&h, &w, sizeof(h));
  return __bfloat1622float2(h);
}
__device__ __forceinline__ float2 pair_f32(uint32_t w, __half) {
  __half2 h;
  memcpy(&h, &w, sizeof(h));
  return __half22float2(h);
}

// VEC elements of T with one load (16 bytes, or one element) and their
// conversion to f32
template <typename T, int VEC>
struct Vec;

template <typename T>
struct Vec<T, 1> {
  using Raw = T;
  static __device__ __forceinline__ Raw load(const T* p) { return __ldg(p); }
  static __device__ __forceinline__ Raw zero() { return from_f32<T>(0.f); }
  static __device__ __forceinline__ void cvt(Raw r, float* f) {
    f[0] = to_f32(r);
  }
};

template <>
struct Vec<float, 4> {
  using Raw = float4;
  static __device__ __forceinline__ Raw load(const float* p) {
    return __ldg(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ Raw zero() {
    return make_float4(0.f, 0.f, 0.f, 0.f);
  }
  static __device__ __forceinline__ void cvt(Raw r, float* f) {
    f[0] = r.x;
    f[1] = r.y;
    f[2] = r.z;
    f[3] = r.w;
  }
};

template <typename T>
struct Vec16x8 {  // 8 bf16 or f16
  using Raw = uint4;
  static __device__ __forceinline__ Raw load(const T* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
  static __device__ __forceinline__ Raw zero() { return make_uint4(0, 0, 0, 0); }
  static __device__ __forceinline__ void cvt(Raw r, float* f) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = pair_f32(w[i], T());
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};
template <>
struct Vec<__nv_bfloat16, 8> : Vec16x8<__nv_bfloat16> {};
template <>
struct Vec<__half, 8> : Vec16x8<__half> {};

__device__ __forceinline__ int clamp_len(const Params& p, int b) {
  return min(max(p.lengths[b], 0), p.max_pages * p.page);
}

// grid (n_chunks, H, B); block kThreads. Lane group g (LPR lanes) reads
// positions c0 + g, c0 + g + groups, ...; lane r of a group holds
// elements (r + LPR * i) * VEC + [0, VEC) of q, K, V and the accumulator,
// i < NV.
template <typename T, int VEC, int NV>
__global__ void __launch_bounds__(kThreads)
paged_decode_split_kernel(const Params p) {
  using V = Vec<T, VEC>;
  using Raw = typename V::Raw;
  __shared__ int s_pid[kMaxChunkPages];
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  __shared__ float s_o[kWarps][kMaxD];

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int len = clamp_len(p, b);
  const int c0 = c * p.chunk;
  if (c > 0 && c0 >= len) return;  // past the row's end
  const int c1 = min(c0 + p.chunk, len);  // empty only for a length-0 row

  // the chunk's page ids, once, before any K/V load
  const int n_pg = (c1 - c0 + p.page - 1) / p.page;
  const int* row = p.table + (int64_t)b * p.max_pages + c0 / p.page;
  for (int i = threadIdx.x; i < n_pg; i += kThreads)
    s_pid[i] = min(max(row[i], 0), p.num_pages - 1);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int lpr = 1 << p.lpr_log2;
  const int groups = kWarps * (32 >> p.lpr_log2);
  const int r = lane & (lpr - 1);
  const int g = warp * (32 >> p.lpr_log2) + (lane >> p.lpr_log2);

  // q pre-scaled into the log2 domain: scores are log2-probabilities
  float qf[NV][VEC];
  const T* qp = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int e = (r + lpr * i) * VEC;
    V::cvt(e < p.D ? V::load(qp + e) : V::zero(), qf[i]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) qf[i][j] *= p.s2_scale;
  }

  float m = kNegInf, l = 0.f;
  float acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;

  const T* kb = static_cast<const T*>(p.k) + h * p.kv_sh;
  const T* vb = static_cast<const T*>(p.v) + h * p.kv_sh;
  // the trip count is the block's: every lane of a warp takes part in the
  // shuffles, positions past c1 are masked
  for (int base = c0; base < c1; base += groups * kUnroll) {
    Raw kr[kUnroll][NV], vr[kUnroll][NV];
    // issue every load of the kUnroll positions before any arithmetic
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int pos = base + u * groups + g;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        kr[u][i] = V::zero();
        vr[u][i] = V::zero();
      }
      if (pos < c1) {
        const int j = pos - c0;
        const int64_t off = (int64_t)s_pid[j / p.page] * p.kv_sp +
                            (int64_t)(j % p.page) * p.kv_ss;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          const int e = (r + lpr * i) * VEC;
          if (e < p.D) {
            kr[u][i] = V::load(kb + off + e);
            vr[u][i] = V::load(vb + off + e);
          }
        }
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float kf[VEC];
        V::cvt(kr[u][i], kf);
#pragma unroll
        for (int j = 0; j < VEC; ++j) s[u] += qf[i][j] * kf[j];
      }
      for (int o = lpr >> 1; o > 0; o >>= 1)
        s[u] += __shfl_xor_sync(kFull, s[u], o);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (base + u * groups + g < c1) m_new = fmaxf(m_new, s[u]);
    const float alpha = exp2f(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[i][j] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (base + u * groups + g < c1) {
        const float pr = exp2f(s[u] - m_new);
        l += pr;
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float vf[VEC];
          V::cvt(vr[u][i], vf);
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[i][j] += pr * vf[j];
        }
      }
    }
    m = m_new;
  }

  // merge the lane groups of the warp (a group that saw no position has
  // m = -1e30, l = 0, acc = 0 and adds nothing), then the warps
  for (int o = lpr; o < 32; o <<= 1) {
    const float m_o = __shfl_xor_sync(kFull, m, o);
    const float l_o = __shfl_xor_sync(kFull, l, o);
    const float mm = fmaxf(m, m_o);
    const float a = exp2f(m - mm), a_o = exp2f(m_o - mm);
    l = l * a + l_o * a_o;
#pragma unroll
    for (int i = 0; i < NV; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        acc[i][j] = acc[i][j] * a + __shfl_xor_sync(kFull, acc[i][j], o) * a_o;
    m = mm;
  }
  if (lane < lpr) {  // the warp's first group holds its merged state
    if (lane == 0) {
      s_m[warp] = m;
      s_l[warp] = l;
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int e = (r + lpr * i) * VEC;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        if (e + j < p.D) s_o[warp][e + j] = acc[i][j];
    }
  }
  __syncthreads();

  float M = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) M = fmaxf(M, s_m[w]);
  float sc[kWarps], L = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    sc[w] = exp2f(s_m[w] - M);
    L += s_l[w] * sc[w];
  }
  const int64_t bh = (int64_t)b * p.H + h;
  if (len <= p.chunk) {  // the row's only chunk: write the output
    const float denom = fmaxf(L, 1e-30f);
    T* op = static_cast<T*>(p.out) + bh * p.D;
    for (int d = threadIdx.x; d < p.D; d += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += s_o[w][d] * sc[w];
      op[d] = from_f32<T>(o / denom);
    }
  } else {  // a partial, for paged_decode_merge_kernel
    const int64_t part = bh * p.n_chunks + c;
    float* po = p.ws + part * p.D;
    for (int d = threadIdx.x; d < p.D; d += kThreads) {
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) o += s_o[w][d] * sc[w];
      po[d] = o;
    }
    if (threadIdx.x == 0) {
      float* ml = p.ws + (int64_t)p.B * p.H * p.n_chunks * p.D + 2 * part;
      ml[0] = M;
      ml[1] = L;
    }
  }
}

// grid B * H; block kMergeThreads. Combines the partials of a row longer
// than one chunk, chunk 0 first.
template <typename T>
__global__ void __launch_bounds__(kMergeThreads)
paged_decode_merge_kernel(const Params p) {
  const int64_t bh = blockIdx.x;
  const int len = clamp_len(p, (int)(bh / p.H));
  if (len <= p.chunk) return;  // written by its one block
  const int nc = (len + p.chunk - 1) / p.chunk;
  const float* po = p.ws + bh * p.n_chunks * p.D;
  const float* ml =
      p.ws + (int64_t)p.B * p.H * p.n_chunks * p.D + 2 * bh * p.n_chunks;
  float M = kNegInf;
  for (int c = 0; c < nc; ++c) M = fmaxf(M, ml[2 * c]);
  float L = 0.f;
  for (int c = 0; c < nc; ++c) L += ml[2 * c + 1] * exp2f(ml[2 * c] - M);
  const float denom = fmaxf(L, 1e-30f);
  T* op = static_cast<T*>(p.out) + bh * p.D;
  for (int d = threadIdx.x; d < p.D; d += kMergeThreads) {
    float o = 0.f;
    for (int c = 0; c < nc; ++c)
      o += po[(int64_t)c * p.D + d] * exp2f(ml[2 * c] - M);
    op[d] = from_f32<T>(o / denom);
  }
}

template <typename T, int VEC, int NV>
cudaError_t launch_split(const Params& p, cudaStream_t stream) {
  const dim3 grid(p.n_chunks, p.H, p.B);
  paged_decode_split_kernel<T, VEC, NV><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

template <typename T>
cudaError_t launch_typed(Params p, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = p.D % kVec == 0 && aligned16(p.q) && aligned16(p.k) &&
                   aligned16(p.v) && p.q_sb % kVec == 0 &&
                   p.q_sh % kVec == 0 && p.kv_sp % kVec == 0 &&
                   p.kv_ss % kVec == 0 && p.kv_sh % kVec == 0;
  const int n_loads = vec ? p.D / kVec : p.D;  // loads a row takes
  p.lpr_log2 = 0;
  while ((1 << p.lpr_log2) < n_loads && p.lpr_log2 < 5) ++p.lpr_log2;
  const int nv = (n_loads + (1 << p.lpr_log2) - 1) >> p.lpr_log2;
  cudaError_t err;
  if (vec)  // at most 64 loads a row (f32, D 256): nv <= 2
    err = nv == 1 ? launch_split<T, kVec, 1>(p, stream)
                  : launch_split<T, kVec, 2>(p, stream);
  else  // at most 256 loads a row: nv <= 8
    err = nv == 1   ? launch_split<T, 1, 1>(p, stream)
          : nv == 2 ? launch_split<T, 1, 2>(p, stream)
          : nv <= 4 ? launch_split<T, 1, 4>(p, stream)
                    : launch_split<T, 1, 8>(p, stream);
  if (err != cudaSuccess || p.n_chunks == 1) return err;
  paged_decode_merge_kernel<T><<<p.B * p.H, kMergeThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, 2 = float16 (q, K/V and out share it).
// chunk: positions per block, a multiple of page, at most 512 pages.
// ws: float32 scratch of B * H * n_chunks * (D + 2) elements, with
// n_chunks = ceil(max_pages * page / chunk); unused (may be null) when
// n_chunks is 1. Launches on `stream`; returns the first cudaError_t
// (0 = cudaSuccess).
extern "C" int paged_decode_attention(
    const void* q, const void* k, const void* v, const int* table,
    const int* lengths, void* out, float* ws, int dtype, int B, int H, int D,
    int page, int max_pages, int num_pages, int chunk, long long q_sb,
    long long q_sh, long long kv_sp, long long kv_ss, long long kv_sh,
    float s2_scale, void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || D <= 0 || D > kMaxD ||
      page <= 0 || max_pages <= 0 || num_pages <= 0 || chunk <= 0 ||
      chunk % page != 0 || chunk / page > kMaxChunkPages ||
      (long long)max_pages * page > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int max_len = max_pages * page;
  const int n_chunks = (max_len + chunk - 1) / chunk;
  if (n_chunks > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  const Params p{q,     k,     v,     table, lengths, out,
                 ws,    B,     H,     D,     page,    max_pages,
                 num_pages,    chunk, n_chunks,      0 /* lpr_log2 */,
                 q_sb,  q_sh,  kv_sp, kv_ss, kv_sh,   s2_scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return (int)launch_typed<float>(p, st);
    case 1:
      return (int)launch_typed<__nv_bfloat16>(p, st);
    case 2:
      return (int)launch_typed<__half>(p, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

namespace {

PyObject* py_launch(PyObject*, PyObject* const* a, Py_ssize_t n) {
  using namespace mxt_py;
  if (!nargs(n, 22, "paged_decode_attention")) return nullptr;
  const void *q = ptr(a[0]), *k = ptr(a[1]), *v = ptr(a[2]);
  const int* table = static_cast<const int*>(ptr(a[3]));
  const int* lengths = static_cast<const int*>(ptr(a[4]));
  void* out = ptr(a[5]);
  float* ws = static_cast<float*>(ptr(a[6]));
  const int dtype = i32(a[7]), B = i32(a[8]), H = i32(a[9]), D = i32(a[10]),
            page = i32(a[11]), max_pages = i32(a[12]),
            num_pages = i32(a[13]), chunk = i32(a[14]);
  const long long q_sb = i64(a[15]), q_sh = i64(a[16]), kv_sp = i64(a[17]),
                  kv_ss = i64(a[18]), kv_sh = i64(a[19]);
  const float s2_scale = f32(a[20]);
  void* stream = ptr(a[21]);
  if (PyErr_Occurred()) return nullptr;
  int err;
  Py_BEGIN_ALLOW_THREADS
  err = paged_decode_attention(q, k, v, table, lengths, out, ws, dtype, B, H,
                               D, page, max_pages, num_pages, chunk, q_sb,
                               q_sh, kv_sp, kv_ss, kv_sh, s2_scale, stream);
  Py_END_ALLOW_THREADS
  return PyLong_FromLong(err);
}

}  // namespace

MXT_PY_MODULE(paged_decode_attention, py_launch)
