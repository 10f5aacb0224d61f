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
// Reddit, N = 232,965 x 256 f32: 477 MB, about 0.14 ms at 3.35 TB/s; at
// ogbn-products, N = 2,449,029: 5.04 GB, about 1.50 ms); the backward reads x
// and g and writes dx (about 0.21 ms at Reddit).
//
// Forward design. A row is one warp's: lane l holds the contiguous channels
// [l * PER, (l + 1) * PER) in registers (dim <= 1024), so x is read once and
// lane order is channel order.
//  - A persistent row walk: the grid is one wave of resident blocks; warp w
//    of W walks rows w, w + W, ... and keeps the loads of its next kDepth
//    rows in flight (a register ring, indexed statically by unrolling the
//    walk) while it selects the current one; y and meta stores are not
//    waited on. (A ring of cp.async copies in shared memory, which costs no
//    registers, measured slower.)
//  - A select that starts near the pivot and stops at it. Count passes fix
//    the pivot's key bits from the top, one __reduce_add_sync a bit; the
//    state after a bit is a bucket of keys that holds the pivot. A warp
//    first tests the bucket of its previous row's pivot, one pass with two
//    thresholds (rows of one layer have k-th values alike), then its
//    neighbour; on a hit the passes start below it. They stop as soon as one
//    key is left in the bracket, which is then the pivot with no tie
//    dropped. Only rows with several keys equal to the pivot run to the last
//    bit and settle ties by a warp scan of the lanes' tie counts. bf16 keys
//    (16 bits) count with two instructions a key.
// Backward, one thread per four elements: it needs only the row's (pivot,
// bound), so it is a flat elementwise pass with 16-byte loads.
//
// maxk_fwd_ids and maxk_fwd_bf16_ids are the forward kernels that also
// write the channels each row keeps, ascending, as uint8 ids [N, k] (dim
// <= 256): the channel set of the row's mask exactly, kept zeros included,
// for the sampled backward of the aggregation that reads this MaxK's output
// (csrc/stream.cu stream_sspmm_bf16). A lane counts its kept channels, a
// warp scan of the counts gives its first slot, and it stores its ids
// there: k bytes a row beside the y and meta writes.
//
// maxk_fwd_bf16 and maxk_bwd_bf16 are the same kernels on bf16 rows (the
// 16-bit model, --dtype bfloat16; the TPU kernel takes x in its own dtype and
// writes y in it, maxk_pallas.py:38, :80, :119). Keys come from the exact f32
// widening of each bf16 value, so meta holds the f32 key's bits, as the
// reference's does; those keys differ only in their high 16 bits, so the
// select runs on the 16-bit high halves. y = x * mask and dx = g * mask are
// exact in bf16. A lane loads its contiguous range as 32-bit or wider words
// (16 B at dim 256) and stores y the same way; the backward takes 8 elements
// (16 B) per thread. At Reddit (N = 232,965, dim 256) the forward moves 239
// MB, about 0.07 ms at 3.35 TB/s, the backward 358 MB, about 0.11 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
// rows a warp keeps in flight beyond the one it selects (measured best of
// 1 to 4 at the recipes' shapes, f32 and bf16: utils/maxk_sweep.py)
constexpr int kDepth = 3;

__device__ __forceinline__ uint32_t ordered_key(float v) {
  const uint32_t b = __float_as_uint(v);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// bf16 value 2j in the low half of word j, widened exactly
__device__ __forceinline__ void widen2(unsigned w, float& lo, float& hi) {
  lo = __uint_as_float(w << 16);
  hi = __uint_as_float(w & 0xffff0000u);
}

// A lane's PER channels of one row as loaded: f32 values (T float) or bf16
// bits (T uint16_t), so that the loads can be issued rows before the values
// are used. FULL: the lane's range lies inside the row and is aligned for
// its vector width (dim == 32 * PER, and PER % 4 == 0 for f32, PER even for
// bf16).
template <class T, int PER, bool FULL>
struct RowBuf;

template <int PER, bool FULL>
struct RowBuf<float, PER, FULL> {
  float r[PER];

  __device__ __forceinline__ void load(const float* p, int valid) {
    if constexpr (FULL) {
#pragma unroll
      for (int i = 0; i < PER; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + i);
        r[i] = q.x; r[i + 1] = q.y; r[i + 2] = q.z; r[i + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) r[i] = i < valid ? p[i] : 0.f;
    }
  }

  __device__ __forceinline__ void widen(float (&v)[PER]) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) v[i] = r[i];
  }

  // order-preserving keys (channels past dim: 0)
  __device__ __forceinline__ void keys(uint32_t (&key)[PER],
                                       int valid) const {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      key[i] = (FULL || i < valid) ? ordered_key(r[i]) : 0u;
  }
};

template <int PER, bool FULL>
struct RowBuf<uint16_t, PER, FULL> {
  // FULL: 32-bit words, loaded 16, 8 or 4 B at once; else one value a word
  static constexpr int NW = FULL ? PER / 2 : PER;
  unsigned r[NW];

  __device__ __forceinline__ void load(const uint16_t* p, int valid) {
    if constexpr (FULL) {
      if constexpr (NW % 4 == 0) {
#pragma unroll
        for (int j = 0; j < NW; j += 4) {
          const uint4 q = *reinterpret_cast<const uint4*>(p + 2 * j);
          r[j] = q.x; r[j + 1] = q.y; r[j + 2] = q.z; r[j + 3] = q.w;
        }
      } else if constexpr (NW % 2 == 0) {
#pragma unroll
        for (int j = 0; j < NW; j += 2) {
          const uint2 q = *reinterpret_cast<const uint2*>(p + 2 * j);
          r[j] = q.x; r[j + 1] = q.y;
        }
      } else {
#pragma unroll
        for (int j = 0; j < NW; ++j)
          r[j] = *reinterpret_cast<const unsigned*>(p + 2 * j);
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) r[i] = i < valid ? p[i] : 0u;
    }
  }

  __device__ __forceinline__ void widen(float (&v)[PER]) const {
    if constexpr (FULL) {
#pragma unroll
      for (int j = 0; j < NW; ++j) widen2(r[j], v[2 * j], v[2 * j + 1]);
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) v[i] = __uint_as_float(r[i] << 16);
    }
  }

  // 16-bit order-preserving keys straight from the bits: h ^ 0x8000 for
  // h >= +0, ~h for h <= -0 (channels past dim: 0)
  __device__ __forceinline__ void keys(uint32_t (&key)[PER],
                                       int valid) const {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const uint32_t h = FULL ? r[i / 2] >> (16 * (i % 2)) & 0xffffu : r[i];
      key[i] = (FULL || i < valid) ? h ^ (0x8000u | (h >> 15) * 0x7fffu)
                                   : 0u;
    }
  }
};

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

// count(key >= c) over a lane's keys. KB: key bits, 32 (f32) or 16 (bf16:
// the high half of the f32 key). 16-bit keys take two instructions a key:
// key - c wraps past 2^31 exactly when key < c. Keys past dim are 0, below
// every c >= 1.
template <int KB, int PER>
__device__ __forceinline__ int count_ge(const uint32_t (&key)[PER],
                                        uint32_t c) {
  if constexpr (KB == 16) {
    int lt = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) lt += (key[i] - c) >> 31;
    return PER - lt;
  } else {
    int ge = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) ge += key[i] >= c;
    return ge;
  }
}

// count(key >= a) and count(key >= b) over the warp in one reduction (each
// <= 1024, so both fit a word). a == 0 counts every channel of the row; a
// threshold of 2^KB or more counts none.
template <int KB, int PER>
__device__ __forceinline__ void count2(const uint32_t (&key)[PER], uint64_t a,
                                       uint64_t b, int dim, int& ca,
                                       int& cb) {
  constexpr uint64_t kTop = 1ull << KB;
  const int na = a < kTop ? count_ge<KB>(key, (uint32_t)a) : 0;
  const int nb = b < kTop ? count_ge<KB>(key, (uint32_t)b) : 0;
  const int both = __reduce_add_sync(kFull, na | nb << 16);
  ca = a == 0 ? dim : both & 0xffff;
  cb = both >> 16;
}

// Where the warp's next pivot may lie: the bucket of the previous pivot's
// bits at and above `level` (KB or more: no guess).
struct Guess {
  uint32_t pivot = 0;
  int level = 32;
};

// The row's pivot t (the k-th largest key) and tie bound (the first channel
// of a tie that is dropped, dim if none is), from KB-bit keys held PER to a
// lane in channel order (lane l: channels c0 = l * PER onwards; channels
// past dim have key 0).
//
// Count passes fix t's bits from the top: after bit b, t's bits at and
// above b are the pivot's, lo keys are >= t and hi keys >= t + 2^b, with
// lo >= k > hi. The state after bit L is the bucket [t, t + 2^L) that
// holds the pivot, so a warp first tests the bucket of its previous row's
// pivot at a level five bits above where that row's passes left one key
// (one pass with two thresholds), then its neighbour on the side the counts
// point to, and on a hit starts the passes below L. The passes stop when
// one key is left in the bracket: it is the pivot, k - 1 keys lie above it
// and no tie is dropped. Otherwise every bit is fixed, lo - hi keys equal
// t, hi lie above it, and a warp scan of the lanes' tie counts finds the
// first tie past the k - hi kept.
template <int KB, int PER, bool FULL>
__device__ __forceinline__ void select_row(const uint32_t (&key)[PER],
                                           int c0, int dim, int k, int lane,
                                           Guess& guess, uint32_t& t_out,
                                           int& bound_out) {
  uint32_t t = 0;
  int lo = dim, hi = 0, bit = KB - 1;
  bool hit = false;
  if (guess.level < KB) {
    const int L = guess.level;
    const uint64_t w = 1ull << L;
    const uint64_t g = guess.pivot & ~(uint32_t)(w - 1);
    int c_g, c_up;
    count2<KB>(key, g, g + w, dim, c_g, c_up);
    if (c_g >= k && c_up < k) {
      t = (uint32_t)g, lo = c_g, hi = c_up, hit = true;
    } else if (c_g < k && g != 0) {  // the pivot lies below the bucket
      int c, unused;
      count2<KB>(key, g - w, 1ull << KB, dim, c, unused);
      if (c >= k) t = (uint32_t)(g - w), lo = c, hi = c_g, hit = true;
    } else if (c_up >= k) {  // above it
      int c, unused;
      count2<KB>(key, g + 2 * w, 1ull << KB, dim, c, unused);
      if (c < k) t = (uint32_t)(g + w), lo = c_up, hi = c, hit = true;
    }
    if (hit) bit = L - 1;
  }
  for (; bit >= 0 && lo - hi > 1; --bit) {
    const uint32_t cand = t | (1u << bit);
    const int c = __reduce_add_sync(kFull, count_ge<KB>(key, cand));
    if (c >= k) {
      t = cand;
      lo = c;
    } else {
      hi = c;
    }
  }
  // the next row's guess: five bits above where one key was left, about
  // where 32 keys were; a tie-heavy row leaves the guess as it is
  if (lo - hi == 1) guess.level = bit + 6 < KB ? bit + 6 : KB - 1;

  int bound = dim;
  if (lo - hi == 1) {  // one key in [t, t + 2^(bit + 1)): the pivot
    const uint32_t high = bit + 1 >= 32 ? 0u : ~0u << (bit + 1);
    uint32_t m = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      if (((key[i] ^ t) & high) == 0 && key[i] > m) m = key[i];
    t = __reduce_max_sync(kFull, m);
  } else if (lo > k) {  // ties past the k - hi kept: find the first dropped
    const int budget = k - hi;
    int ties = 0;
#pragma unroll
    for (int i = 0; i < PER; ++i) ties += (FULL || c0 + i < dim) && key[i] == t;
    int incl = ties;  // inclusive scan of tie counts over lanes
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    int rank = incl - ties;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const bool tie = (FULL || c0 + i < dim) && key[i] == t;
      if (tie && rank == budget) bound = c0 + i;
      rank += tie;
    }
    bound = (int)__reduce_min_sync(kFull, (unsigned)bound);
  }
  guess.pivot = t;
  t_out = t;
  bound_out = bound;
}

// registers a thread may take: PER <= 8 keeps 4 blocks (32 warps) an SM
template <int PER>
constexpr int min_blocks() {
  return PER <= 8 ? 4 : (PER <= 16 ? 2 : 1);
}

// T: float (f32 rows) or uint16_t (bf16 rows, their bits).
// IDS: also the kept channels, ascending, into ids uint8 [n, k].
template <class T, int PER, bool FULL, int DEPTH, bool IDS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, min_blocks<PER>())
maxk_fwd_kernel(const T* __restrict__ x, T* __restrict__ y,
                int* __restrict__ meta, uint8_t* __restrict__ ids, int64_t n,
                int dim, int k) {
  constexpr int KB = sizeof(T) == 2 ? 16 : 32;  // key bits
  const int lane = threadIdx.x & 31;
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  const int c0 = lane * PER;
  const int n_valid = dim - c0;  // channels of the lane's range in the row
  int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);

  Guess guess;
  RowBuf<T, PER, FULL> ring[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (row + d * stride < n)
      ring[d].load(x + (row + d * stride) * dim + c0, n_valid);

  for (; row < n; row += DEPTH * stride) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {  // unrolled: ring[d] stays registers
      const int64_t r = row + d * stride;
      if (r >= n) break;  // uniform across the warp
      const RowBuf<T, PER, FULL> cur = ring[d];
      const int64_t ahead = r + DEPTH * stride;
      if (ahead < n) ring[d].load(x + ahead * dim + c0, n_valid);

      // bf16: the key of the exact f32 widening has low half 0 (x >= +0)
      // or 0xffff (x <= -0); its high half orders the values
      uint32_t key[PER];
      cur.keys(key, n_valid);
      uint32_t t;
      int bound;
      select_row<KB, PER, FULL>(key, c0, dim, k, lane, guess, t, bound);
      float v[PER];
      cur.widen(v);
      float out[PER];
      bool kept[PER];
      const int nb = bound - c0;  // the lane's channels before the bound
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        // 16-bit keys: key + 1 > t is key >= t, without overflow
        const bool keep =
            KB == 16 ? key[i] + (i < nb ? 1u : 0u) > t
                     : key[i] > t || (key[i] == t && i < nb);
        kept[i] = keep && (FULL || i < n_valid);
        out[i] = v[i] * (keep ? 1.f : 0.f);  // x * mask, as the plain version
      }
      store_range<PER, FULL>(y + r * dim + c0, n_valid, out);
      if constexpr (IDS) {
        int cnt = 0;
#pragma unroll
        for (int i = 0; i < PER; ++i) cnt += kept[i];
        int incl = cnt;  // inclusive scan of the kept counts over lanes
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int o = __shfl_up_sync(kFull, incl, off);
          if (lane >= off) incl += o;
        }
        uint8_t* out_ids = ids + r * k + (incl - cnt);
        int slot = 0;
#pragma unroll
        for (int i = 0; i < PER; ++i)
          if (kept[i]) out_ids[slot++] = (uint8_t)(c0 + i);
      }
      if (KB == 16) t = t << 16 | ((t & 0x8000u) ? 0u : 0xffffu);
      if (lane == 0)
        *reinterpret_cast<int2*>(meta + 2 * r) = make_int2((int)t, bound);
    }
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

// Blocks of one wave: as many as can be resident on every SM at once.
template <class Kernel>
int64_t wave_blocks(Kernel kernel) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                kWarpsPerBlock * 32, 0);
  return (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
}

// FULL ranges: f32 needs PER % 4 == 0 (float4), bf16 an even PER (words)
template <class T, int PER, bool FULL, bool IDS>
void launch_fwd_at(const T* x, T* y, int* meta, uint8_t* ids, int64_t n,
                   int dim, int k, cudaStream_t s) {
  auto kernel = maxk_fwd_kernel<T, PER, FULL, kDepth, IDS>;
  static const int64_t wave = wave_blocks(kernel);  // per instantiation
  const int64_t need = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<(unsigned)(need < wave ? need : wave), kWarpsPerBlock * 32, 0,
           s>>>(x, y, meta, ids, n, dim, k);
}

template <class T, int PER, bool IDS>
void launch_fwd(const T* x, T* y, int* meta, uint8_t* ids, int64_t n,
                int dim, int k, cudaStream_t s) {
  constexpr bool kVec = sizeof(T) == 2 ? PER % 2 == 0 : PER % 4 == 0;
  if (kVec && dim == 32 * PER)
    launch_fwd_at<T, PER, kVec, IDS>(x, y, meta, ids, n, dim, k, s);
  else
    launch_fwd_at<T, PER, false, IDS>(x, y, meta, ids, n, dim, k, s);
}

// IDS needs dim <= 256 (uint8 ids): PER <= 8
template <class T, bool IDS>
int fwd(const void* x, void* y, void* meta, void* ids, int64_t n, int dim,
        int k, void* stream) {
  if (dim < 1 || dim > (IDS ? 256 : 1024) || k < 1 || k >= dim ||
      (IDS && ids == nullptr))
    return (int)cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  T* yp = static_cast<T*>(y);
  int* mp = static_cast<int*>(meta);
  uint8_t* ip = static_cast<uint8_t*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (dim + 31) / 32;
  if (per <= 1) launch_fwd<T, 1, IDS>(xp, yp, mp, ip, n, dim, k, s);
  else if (per <= 2) launch_fwd<T, 2, IDS>(xp, yp, mp, ip, n, dim, k, s);
  else if (per <= 4) launch_fwd<T, 4, IDS>(xp, yp, mp, ip, n, dim, k, s);
  else if (per <= 8) launch_fwd<T, 8, IDS>(xp, yp, mp, ip, n, dim, k, s);
  else if constexpr (!IDS) {
    if (per <= 16) launch_fwd<T, 16, false>(xp, yp, mp, ip, n, dim, k, s);
    else launch_fwd<T, 32, false>(xp, yp, mp, ip, n, dim, k, s);
  }
  return (int)cudaGetLastError();
}

}  // namespace


// y, meta <- MaxK(x); x, y f32 [n, dim] row-major, meta int32 [n, 2].
// Needs 1 <= k < dim <= 1024, 16-byte aligned x and y and an 8-byte aligned
// meta.
extern "C" int maxk_fwd(const void* x, void* y, void* meta, int64_t n,
                        int dim, int k, void* stream) {
  return fwd<float, false>(x, y, meta, nullptr, n, dim, k, stream);
}

// maxk_fwd, and ids uint8 [n, k] <- the channels each row keeps, ascending.
// Needs dim <= 256; otherwise as maxk_fwd.
extern "C" int maxk_fwd_ids(const void* x, void* y, void* meta, void* ids,
                            int64_t n, int dim, int k, void* stream) {
  return fwd<float, true>(x, y, meta, ids, n, dim, k, stream);
}

// maxk_fwd on x, y bf16 [n, dim] (meta as in maxk_fwd, the f32 keys' bits).
// Needs 1 <= k < dim <= 1024, 16-byte aligned x and y and an 8-byte aligned
// meta.
extern "C" int maxk_fwd_bf16(const void* x, void* y, void* meta, int64_t n,
                             int dim, int k, void* stream) {
  return fwd<uint16_t, false>(x, y, meta, nullptr, n, dim, k, stream);
}

// maxk_fwd_bf16 with the kept channels' ids, as maxk_fwd_ids.
extern "C" int maxk_fwd_bf16_ids(const void* x, void* y, void* meta,
                                 void* ids, int64_t n, int dim, int k,
                                 void* stream) {
  return fwd<uint16_t, true>(x, y, meta, ids, n, dim, k, stream);
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
