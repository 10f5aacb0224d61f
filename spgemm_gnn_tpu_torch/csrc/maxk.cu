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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ uint32_t ordered_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// VEC: dim == 32 * PER and PER % 4 == 0, so every lane's range is full and
// 16-byte aligned.
template <int PER, bool VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
maxk_fwd_kernel(const float* __restrict__ x, float* __restrict__ y,
                int* __restrict__ meta, int64_t n, int dim, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // row is uniform across the warp
  const float* xr = x + row * dim;
  float* yr = y + row * dim;
  const int c0 = lane * PER;

  float v[PER];
  uint32_t key[PER];
  bool valid[PER];
  if (VEC) {
#pragma unroll
    for (int i = 0; i < PER; i += 4) {
      const float4 q = *reinterpret_cast<const float4*>(xr + c0 + i);
      v[i] = q.x; v[i + 1] = q.y; v[i + 2] = q.z; v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = (c0 + i < dim) ? xr[c0 + i] : 0.f;
  }
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    valid[i] = c0 + i < dim;
    key[i] = ordered_key(v[i]);
  }

  // pivot: the largest t with count(key >= t) >= k, one bit at a time
  uint32_t t = 0;
  for (int bit = 31; bit >= 0; --bit) {
    const uint32_t cand = t | (1u << bit);
    int cnt = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) cnt += (valid[i] && key[i] >= cand);
    if (__reduce_add_sync(kFull, cnt) >= k) t = cand;
  }

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
  if (VEC) {
#pragma unroll
    for (int i = 0; i < PER; i += 4)
      *reinterpret_cast<float4*>(yr + c0 + i) =
          make_float4(out[i], out[i + 1], out[i + 2], out[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (valid[i]) yr[c0 + i] = out[i];
  }
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

template <int PER>
void launch_fwd(const float* x, float* y, int* meta, int64_t n, int dim,
                int k, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (PER % 4 == 0 && dim == 32 * PER)
    maxk_fwd_kernel<PER, (PER % 4 == 0)>
        <<<blocks, kWarpsPerBlock * 32, 0, s>>>(x, y, meta, n, dim, k);
  else
    maxk_fwd_kernel<PER, false>
        <<<blocks, kWarpsPerBlock * 32, 0, s>>>(x, y, meta, n, dim, k);
}

}  // namespace

// y, meta <- MaxK(x); x, y f32 [n, dim] row-major, meta int32 [n, 2].
// Needs 1 <= k < dim <= 1024 and 16-byte aligned x and y.
extern "C" int maxk_fwd(const void* x, void* y, void* meta, int64_t n,
                        int dim, int k, void* stream) {
  if (dim < 1 || dim > 1024 || k < 1 || k >= dim) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* yp = static_cast<float*>(y);
  int* mp = static_cast<int*>(meta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (dim + 31) / 32;
  if (per <= 1) launch_fwd<1>(xp, yp, mp, n, dim, k, s);
  else if (per <= 2) launch_fwd<2>(xp, yp, mp, n, dim, k, s);
  else if (per <= 4) launch_fwd<4>(xp, yp, mp, n, dim, k, s);
  else if (per <= 8) launch_fwd<8>(xp, yp, mp, n, dim, k, s);
  else if (per <= 16) launch_fwd<16>(xp, yp, mp, n, dim, k, s);
  else launch_fwd<32>(xp, yp, mp, n, dim, k, s);
  return (int)cudaGetLastError();
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
