// MaxK forward and backward for Hopper (sm_90a).
//
// Replaces the TPU kernel spgemm_gnn_tpu/kernels/maxk_pallas.py::_maxk_kernel
// (forward, through maxk_pallas) and its backward _maxk_bwd/_mask_from_meta.
//
// Semantics, bit for bit those of the plain version (ops/maxk.py): floats map
// to order-preserving uint32 keys (-0.0 below +0.0); the pivot is the k-th
// largest key; ties at the pivot keep the lowest channel indices. The forward
// writes y = x * mask and meta = (pivot bits, tie bound) as int32 [N, 2]; the
// backward rebuilds the mask from (x, meta), so no [N, dim] mask is stored.
//
// Bound on this card: memory. The forward reads x and writes y once (at
// Reddit, N = 232,965 x 256 f32: 477 MB, about 0.14 ms at 3.35 TB/s); the
// backward reads x and g and writes dx (about 0.21 ms). The 32 count passes
// are register work.
//
// Design: forward, one warp per row and 8 rows per block. A lane holds a
// contiguous range of PER channels in registers (dim <= 1024), so x is read
// once. The pivot comes from 32 warp-wide count passes (__reduce_add_sync),
// one per key bit, with no shared memory and no sort. Ties are settled by a
// warp exclusive scan of per-lane tie counts: because ranges are contiguous
// and in lane order, the scan gives each tie its rank in channel order, and
// the first tie past the budget is the bound. Backward, one thread per four
// elements: it needs only the row's (pivot, bound), so it is a flat
// elementwise pass with 16-byte loads.
//
// maxk_fwd_bf16 and maxk_bwd_bf16 are the same kernels on bf16 rows (the
// 16-bit model, --dtype bfloat16; the TPU kernel takes x in its own dtype and
// writes y in it, maxk_pallas.py:38, :80, :119). Keys come from the exact f32
// widening of each bf16 value, so meta holds the f32 key's bits, as the
// reference's does; those keys differ only in their high 16 bits, so 16 count
// passes find the pivot. y = x * mask and dx = g * mask are exact in bf16. A
// lane loads its contiguous range as 32-bit or wider words (16 B at dim 256)
// and stores y the same way; the backward takes 8 elements (16 B) per
// thread. At Reddit (N = 232,965, dim 256) the forward moves 239 MB, about
// 0.07 ms at 3.35 TB/s, the backward 358 MB, about 0.11 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint32_t ordered_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// A lane's PER channels of a row, as f32 (T float: f32 rows; T uint16_t:
// bf16 rows, their bits). FULL: the lane's range lies inside the row and is
// aligned for its vector width (dim == 32 * PER, and PER % 4 == 0 for f32,
// PER even for bf16).
template <int PER, bool FULL>
__device__ __forceinline__ void load_range(const float* p, int valid,
                                           float (&v)[PER]) {
  if constexpr (FULL) {
#pragma unroll
    for (int i = 0; i < PER; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(p + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = i < valid ? p[i] : 0.f;
  }
}

// bf16 value 2j in the low half of word j, widened exactly
__device__ __forceinline__ void widen2(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

template <int PER, bool FULL>
__device__ __forceinline__ void load_range(const uint16_t* p, int valid,
                                           float (&v)[PER]) {
  if constexpr (FULL) {
    constexpr int NW = PER / 2;  // 32-bit words, loaded 16, 8 or 4 B at once
    unsigned w[NW];
    if constexpr (NW % 4 == 0) {
#pragma unroll
      for (int j = 0; j < NW; j += 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(p + 2 * j);
        w[j] = q.x; w[j + 1] = q.y; w[j + 2] = q.z; w[j + 3] = q.w;
      }
    } else if constexpr (NW % 2 == 0) {
#pragma unroll
      for (int j = 0; j < NW; j += 2) {
        const uint2 q = *reinterpret_cast<const uint2*>(p + 2 * j);
        w[j] = q.x; w[j + 1] = q.y;
      }
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j)
        w[j] = *reinterpret_cast<const unsigned*>(p + 2 * j);
    }
#pragma unroll
    for (int j = 0; j < NW; ++j) widen2(w[j], v[2 * j], v[2 * j + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      v[i] = i < valid ? __uint_as_float((unsigned)p[i] << 16) : 0.f;
  }
}

template <int PER, bool FULL>
__device__ __forceinline__ void store_range(float* p, int valid,
                                            const float (&v)[PER]) {
  if constexpr (FULL) {
#pragma unroll
    for (int i = 0; i < PER; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (i < valid) p[i] = v[i];
  }
}

// two f32 values, exact in bf16, as one word (the first in the low half)
__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

template <int PER, bool FULL>
__device__ __forceinline__ void store_range(uint16_t* p, int valid,
                                            const float (&v)[PER]) {
  if constexpr (FULL) {
    constexpr int NW = PER / 2;
    unsigned w[NW];
#pragma unroll
    for (int j = 0; j < NW; ++j) w[j] = pack2(v[2 * j], v[2 * j + 1]);
    if constexpr (NW % 4 == 0) {
#pragma unroll
      for (int j = 0; j < NW; j += 4)
        *reinterpret_cast<uint4*>(p + 2 * j) =
            make_uint4(w[j], w[j + 1], w[j + 2], w[j + 3]);
    } else if constexpr (NW % 2 == 0) {
#pragma unroll
      for (int j = 0; j < NW; j += 2)
        *reinterpret_cast<uint2*>(p + 2 * j) = make_uint2(w[j], w[j + 1]);
    } else {
#pragma unroll
      for (int j = 0; j < NW; ++j)
        *reinterpret_cast<unsigned*>(p + 2 * j) = w[j];
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (i < valid)
        p[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v[i]));
  }
}

// T: float (f32 rows) or uint16_t (bf16 rows, their bits).
template <class T, int PER, bool FULL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
maxk_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                int* __restrict__ meta, int64_t n, int dim, int k) {
  // bf16 keys are ordered by their high 16 bits: search those only
  constexpr int kLowBit = sizeof(T) == 2 ? 16 : 0;
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // row is uniform across the warp
  const int c0 = lane * PER;
  const int n_valid = dim - c0;  // channels of the lane's range in the row

  float v[PER];
  uint32_t key[PER];
  bool valid[PER];
  load_range<PER, FULL>(x + row * dim + c0, n_valid, v);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    valid[i] = c0 + i < dim;
    key[i] = ordered_key(v[i]);
  }

  // pivot: the largest t with count(key >= t) >= k, one bit at a time
  uint32_t t = 0;
  for (int bit = 31; bit >= kLowBit; --bit) {
    const uint32_t cand = t | (1u << bit);
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) cnt += (valid[i] && key[i] >= cand);
    if (__reduce_add_sync(kFull, cnt) >= k) t = cand;
  }
  // bf16: the key of a bf16 value has low half 0 (x >= +0) or 0xffff (x <=
  // -0); t is the pivot's high half, so give it the pivot's low half
  if (kLowBit) t |= (t & 0x80000000u) ? 0u : 0xffffu;

  int greater = 0, ties = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    greater += (valid[i] && key[i] > t);
    ties += (valid[i] && key[i] == t);
  }
  const int budget = k - __reduce_add_sync(kFull, greater);  // ties to keep

  // inclusive scan of tie counts over lanes (= channel order)
  int incl = ties;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  // the tie of rank `budget` (0-based) is the first one dropped
  int bound = dim;
  int rank = incl - ties;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const bool tie = valid[i] && key[i] == t;
    if (tie && rank == budget) bound = c0 + i;
    rank += tie;
  }
  bound = (int)__reduce_min_sync(kFull, (unsigned)bound);

  float out[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const bool keep = valid[i] && (key[i] > t || (key[i] == t && c0 + i < bound));
    out[i] = v[i] * (keep ? 1.f : 0.f);  // x * mask, as the plain version
  }
  store_range<PER, FULL>(y + row * dim + c0, n_valid, out);
  if (lane == 0) {
    meta[2 * row] = (int)t;
    meta[2 * row + 1] = bound;
  }
}

__device__ __forceinline__ float masked(float xv, float gv, uint32_t t,
                                        int bound, int c) {
  const uint32_t key = ordered_key(xv);
  const bool keep = key > t || (key == t && c < bound);
  return gv * (keep ? 1.f : 0.f);
}

// VEC: dim % 4 == 0, one thread per 4 elements of a row
template <bool VEC>
__global__ void maxk_bwd_kernel(const float* __restrict__ x,
                                const int* __restrict__ meta,
                                const float* __restrict__ g,
                                float* __restrict__ dx, int64_t n, int dim) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    const int64_t e = 4 * i;
    if (e >= n * dim) return;
    const int64_t row = e / dim;
    const int c = (int)(e - row * dim);
    const uint32_t t = (uint32_t)meta[2 * row];
    const int bound = meta[2 * row + 1];
    const float4 xv = reinterpret_cast<const float4*>(x)[i];
    const float4 gv = reinterpret_cast<const float4*>(g)[i];
    reinterpret_cast<float4*>(dx)[i] = make_float4(
        masked(xv.x, gv.x, t, bound, c), masked(xv.y, gv.y, t, bound, c + 1),
        masked(xv.z, gv.z, t, bound, c + 2),
        masked(xv.w, gv.w, t, bound, c + 3));
  } else {
    if (i >= n * dim) return;
    const int64_t row = i / dim;
    const int c = (int)(i - row * dim);
    dx[i] = masked(x[i], g[i], (uint32_t)meta[2 * row], meta[2 * row + 1], c);
  }
}

// dx = g * mask on bf16 rows; VEC: dim % 8 == 0, one thread per 8 elements
// (16 B) of a row
template <bool VEC>
__global__ void maxk_bwd16_kernel(const uint16_t* __restrict__ x,
                                  const int* __restrict__ meta,
                                  const uint16_t* __restrict__ g,
                                  uint16_t* __restrict__ dx, int64_t n,
                                  int dim) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    const int64_t e = 8 * i;
    if (e >= n * dim) return;
    const int64_t row = e / dim;
    const int c = (int)(e - row * dim);
    const uint32_t t = (uint32_t)meta[2 * row];
    const int bound = meta[2 * row + 1];
    const uint4 xq = reinterpret_cast<const uint4*>(x)[i];
    const uint4 gq = reinterpret_cast<const uint4*>(g)[i];
    const unsigned xw[4] = {xq.x, xq.y, xq.z, xq.w};
    const unsigned gw[4] = {gq.x, gq.y, gq.z, gq.w};
    unsigned o[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float xl, xh, gl, gh;
      widen2(xw[j], xl, xh);
      widen2(gw[j], gl, gh);
      o[j] = pack2(masked(xl, gl, t, bound, c + 2 * j),
                   masked(xh, gh, t, bound, c + 2 * j + 1));
    }
    reinterpret_cast<uint4*>(dx)[i] = make_uint4(o[0], o[1], o[2], o[3]);
  } else {
    if (i >= n * dim) return;
    const int64_t row = i / dim;
    const int c = (int)(i - row * dim);
    const float d = masked(__uint_as_float((unsigned)x[i] << 16),
                           __uint_as_float((unsigned)g[i] << 16),
                           (uint32_t)meta[2 * row], meta[2 * row + 1], c);
    dx[i] = __bfloat16_as_ushort(__float2bfloat16_rn(d));
  }
}

// FULL ranges: f32 needs PER % 4 == 0 (float4), bf16 an even PER (words)
template <class T, int PER>
void launch_fwd(const T* x, T* y, int* meta, int64_t n, int dim, int k,
                cudaStream_t s) {
  constexpr bool kVec = sizeof(T) == 2 ? PER % 2 == 0 : PER % 4 == 0;
  const unsigned blocks = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (kVec && dim == 32 * PER)
    maxk_fwd_kernel<T, PER, kVec>
        <<<blocks, kWarpsPerBlock * 32, 0, s>>>(x, y, meta, n, dim, k);
  else
    maxk_fwd_kernel<T, PER, false>
        <<<blocks, kWarpsPerBlock * 32, 0, s>>>(x, y, meta, n, dim, k);
}

template <class T>
int fwd(const void* x, void* y, void* meta, int64_t n, int dim, int k,
        void* stream) {
  if (dim < 1 || dim > 1024 || k < 1 || k >= dim)
    return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  int* mp = static_cast<int*>(meta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (dim + 31) / 32;
  if (per <= 1) launch_fwd<T, 1>(xp, yp, mp, n, dim, k, s);
  else if (per <= 2) launch_fwd<T, 2>(xp, yp, mp, n, dim, k, s);
  else if (per <= 4) launch_fwd<T, 4>(xp, yp, mp, n, dim, k, s);
  else if (per <= 8) launch_fwd<T, 8>(xp, yp, mp, n, dim, k, s);
  else if (per <= 16) launch_fwd<T, 16>(xp, yp, mp, n, dim, k, s);
  else launch_fwd<T, 32>(xp, yp, mp, n, dim, k, s);
  return (int)cudaGetLastError();
}

}  // namespace

// y, meta <- MaxK(x); x, y f32 [n, dim] row-major, meta int32 [n, 2].
// Needs 1 <= k < dim <= 1024 and 16-byte aligned x and y.
extern "C" int maxk_fwd(const void* x, void* y, void* meta, int64_t n,
                        int dim, int k, void* stream) {
  return fwd<float>(x, y, meta, n, dim, k, stream);
}

// maxk_fwd on x, y bf16 [n, dim] (meta as in maxk_fwd, the f32 keys' bits).
// Needs 1 <= k < dim <= 1024 and 16-byte aligned x and y.
extern "C" int maxk_fwd_bf16(const void* x, void* y, void* meta, int64_t n,
                             int dim, int k, void* stream) {
  return fwd<uint16_t>(x, y, meta, n, dim, k, stream);
}

// dx <- g * mask(x, meta); x, g, dx f32 [n, dim], meta int32 [n, 2].
extern "C" int maxk_bwd(const void* x, const void* meta, const void* g,
                        void* dx, int64_t n, int dim, void* stream) {
  if (dim < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const bool vec = dim % 4 == 0;
  const int64_t items = vec ? n * dim / 4 : n * dim;
  const unsigned blocks = (unsigned)((items + threads - 1) / threads);
  if (vec)
    maxk_bwd_kernel<true><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(meta),
        static_cast<const float*>(g), static_cast<float*>(dx), n, dim);
  else
    maxk_bwd_kernel<false><<<blocks, threads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(meta),
        static_cast<const float*>(g), static_cast<float*>(dx), n, dim);
  return (int)cudaGetLastError();
}

// dx <- g * mask(x, meta); x, g, dx bf16 [n, dim], meta int32 [n, 2] (from
// maxk_fwd_bf16). Needs 16-byte aligned x, g and dx.
extern "C" int maxk_bwd_bf16(const void* x, const void* meta, const void* g,
                             void* dx, int64_t n, int dim, void* stream) {
  if (dim < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  const bool vec = dim % 8 == 0;
  const int64_t items = vec ? n * dim / 8 : n * dim;
  const unsigned blocks = (unsigned)((items + threads - 1) / threads);
  const uint16_t* xp = static_cast<const uint16_t*>(x);
  const int* mp = static_cast<const int*>(meta);
  const uint16_t* gp = static_cast<const uint16_t*>(g);
  uint16_t* dp = static_cast<uint16_t*>(dx);
  if (vec)
    maxk_bwd16_kernel<true><<<blocks, threads, 0, s>>>(xp, mp, gp, dp, n, dim);
  else
    maxk_bwd16_kernel<false><<<blocks, threads, 0, s>>>(xp, mp, gp, dp, n,
                                                         dim);
  return (int)cudaGetLastError();
}
