// CBSR (per node, k values and k channel ids) for Hopper (sm_90a): the
// compaction of a MaxK-masked row, its inverse, and the channel sampling of
// the SSpMM backward.
//
// Replaces three TPU kernels:
//   cbsr_compact  <- spgemm_gnn_tpu/kernels/maxk_pallas.py::
//                    _cbsr_compact_kernel (through cbsr_compact_pallas);
//   cbsr_densify  <- spgemm_gnn_tpu/kernels/spgemm_pallas.py::
//                    _densify_rows_kernel (densify_rows) and
//                    _densify_t_kernel (densify_transpose, whose [dim, N]
//                    layout is a TPU lane artefact: the port's products read
//                    rows, so one row-major kernel serves both);
//   cbsr_sample   <- spgemm_gnn_tpu/kernels/spgemm_pallas.py::
//                    _sample_channels_kernel (sample_channels).
//
// Semantics, bit for bit those of the plain versions (ops/maxk.py):
//   cbsr_compact: per row, the nonzero channels in ascending order, then the
//     lowest zero channels up to k, with x's values there (the slot order of
//     cbsr_compact_pallas);
//   cbsr_densify: out[n, ch[n, j]] = vals[n, j], 0 elsewhere;
//   cbsr_sample:  out[n, j] = z[n, ch[n, j]].
// Each also takes bf16 (the TPU kernels take the values' dtype and an
// out_dtype, spgemm_pallas.py:285-373, and sample z in its own dtype,
// :385-430): cbsr_densify_bf16 (bf16 -> bf16, the gradient of
// cbsr_compact on bf16 rows), cbsr_densify_bf16_f32 (bf16 -> f32, the
// aggregate_cbsr forward on bf16 values), cbsr_densify_f32_bf16 (f32 ->
// bf16, rounded to nearest even) and cbsr_sample_bf16 (bf16 z and out).
// Channels are int32 in [0, dim) and distinct within a row (the contract of
// the CBSR producers), so no id wraps at dim > 256.
//
// Bound on this card: memory, all three. At ogbn-products (N = 2,449,029,
// dim 256, k 32): compact reads x (2.5 GB) and writes 0.63 GB, about 0.94 ms
// at 3.35 TB/s; densify the reverse; sample moves 0.94 GB (ids, the sampled
// entries and the output), about 0.28 ms.
//
// Design: compact, one warp per row; lane l holds channels l + 32 t, so a
// warp ballot per t lists the nonzero channels of a 32-channel block in
// ascending order and a popcount of the lower lanes gives each its slot; a
// second ballot pass places the zero channels when the row has fewer than k
// nonzeros. Densify, one warp per row: the warp zeroes the row with 16-byte
// stores, then (after __syncwarp, which orders the lanes' stores) lane j
// writes value j at its channel; the row's lines are still in L2 for the
// second pass, so device memory sees each row written about once. (Setting
// each value in its owning lane's registers after k shuffle rounds, and
// writing the row once, took 4.65 ms at these shapes on an H100 at 700 W:
// slower than torch.zeros and scatter_.) The bf16 forms keep that shape: a
// 16-byte zero store covers 8 bf16 channels, so a bf16 output needs dim % 8
// == 0. Sample, one thread per output element.
//
// cbsr_compact_bf16 is the compaction on bf16 rows (the 16-bit model,
// --dtype bfloat16; the TPU kernel writes the values in x's dtype,
// maxk_pallas.py:177-186, :212): bf16 values, int32 channels, the same slots.
// At ogbn-products (N = 2,449,029, dim 256, k 32) it reads 1.25 GB and
// writes 0.47 GB, about 0.51 ms at 3.35 TB/s. Its design is MaxK's forward
// walk (csrc/maxk.cu): a persistent grid of one wave of resident blocks, a
// warp per row, the loads of the warp's next two rows in flight while it
// compacts the current one. A lane holds a contiguous range of PER channels,
// loaded as 32-bit or wider words (16 B at dim 256), so channel order is
// (lane, position) order: one warp scan of the lanes' nonzero and zero
// counts, packed in one word, gives each lane its first nonzero slot and,
// after the row's nonzeros, its first zero slot. The lanes put their slots'
// (channel, value) pairs in a per-warp stage of k entries in shared memory;
// the warp then writes the row's values and channels out of the stage in
// slot order, as 16-byte stores where k % 8 == 0 (k = 32: 4 lanes store the
// 64 B of values, 8 lanes the 128 B of channels), else one slot a lane.
// Values are copied as bits (a -0.0 stays -0.0, as the plain version's
// gather keeps it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kMaxDim = 1024;  // a row lives in one warp's registers
// bf16 rows a compaction warp keeps in flight beyond the one it compacts
constexpr int kDepthBf16 = 2;

// NB: 32-channel blocks per row, ceil(dim / 32) rounded up to a power of two
template <int NB>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cbsr_compact_kernel(const float* __restrict__ x, float* __restrict__ vals,
                    int* __restrict__ ch, int64_t n, int dim, int k) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // row is uniform across the warp
  const float* xr = x + row * dim;
  float* vr = vals + row * k;
  int* cr = ch + row * k;
  const unsigned lower = (1u << lane) - 1u;

  float v[NB];
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    const int c = lane + 32 * t;
    v[t] = c < dim ? xr[c] : 0.f;
  }
  // nonzeros first (NaN counts as nonzero, as x != 0 in the plain version)
  int base = 0;
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    const int c = lane + 32 * t;
    const bool take = c < dim && v[t] != 0.f;
    const unsigned m = __ballot_sync(kFull, take);
    const int slot = base + __popc(m & lower);
    if (take && slot < k) {
      vr[slot] = v[t];
      cr[slot] = c;
    }
    base += __popc(m);
  }
  if (base >= k) return;  // base is uniform across the warp
  // then the lowest zero channels
#pragma unroll
  for (int t = 0; t < NB; ++t) {
    const int c = lane + 32 * t;
    const bool take = c < dim && v[t] == 0.f;
    const unsigned m = __ballot_sync(kFull, take);
    const int slot = base + __popc(m & lower);
    if (take && slot < k) {
      vr[slot] = v[t];
      cr[slot] = c;
    }
    base += __popc(m);
  }
}

// A lane's PER bf16 channels of one row as loaded, so that the loads can be
// issued rows before the values are used. FULL: dim == 32 * PER with PER
// even, so the lane's range is whole words, loaded 16, 8 or 4 B at once;
// else one value a word.
template <int PER, bool FULL>
struct Row16 {
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

  __device__ __forceinline__ void bits(uint16_t (&v)[PER]) const {
    if constexpr (FULL) {
#pragma unroll
      for (int j = 0; j < NW; ++j) {
        v[2 * j] = (uint16_t)(r[j] & 0xffffu);
        v[2 * j + 1] = (uint16_t)(r[j] >> 16);
      }
    } else {
#pragma unroll
      for (int i = 0; i < PER; ++i) v[i] = (uint16_t)r[i];
    }
  }
};

// a warp's stage: k channels, then k values (k rounded up to 8 entries)
__host__ __device__ constexpr int stage16_bytes(int k) {
  return ((k + 7) / 8 * 8) * (int)(sizeof(int) + sizeof(uint16_t));
}

// PER: channels per lane, ceil(dim / 32) rounded up to a power of two;
// FULL: dim == 32 * PER with PER even, so a lane's range is whole words
template <int PER, bool FULL, int DEPTH>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cbsr_compact16_kernel(const uint16_t* __restrict__ x,
                      uint16_t* __restrict__ vals, int* __restrict__ ch,
                      int64_t n, int dim, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int kp = (k + 7) / 8 * 8;
  int* s_ch = reinterpret_cast<int*>(smem + warp * stage16_bytes(k));
  uint16_t* s_val = reinterpret_cast<uint16_t*>(s_ch + kp);
  const int64_t stride = (int64_t)gridDim.x * kWarpsPerBlock;
  const int c0 = lane * PER;
  const int n_valid = dim - c0;
  const bool vec = k % 8 == 0;  // 16-byte rows of values and of channels
  int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp;

  Row16<PER, FULL> ring[DEPTH];
#pragma unroll
  for (int d = 0; d < DEPTH; ++d)
    if (row + d * stride < n)
      ring[d].load(x + (row + d * stride) * dim + c0, n_valid);

  for (; row < n; row += DEPTH * stride) {
#pragma unroll
    for (int d = 0; d < DEPTH; ++d) {  // unrolled: ring[d] stays registers
      const int64_t r = row + d * stride;
      if (r >= n) break;  // uniform across the warp
      uint16_t v[PER];
      ring[d].bits(v);
      const int64_t ahead = r + DEPTH * stride;
      if (ahead < n) ring[d].load(x + ahead * dim + c0, n_valid);

      // a bf16 value is nonzero unless its bits are +0 or -0 (NaN counts as
      // nonzero, as x != 0 in the plain version); nonzero counts in the low
      // half of a word, zero counts in the high half (each <= 1024)
      int counts = 0;
#pragma unroll
      for (int i = 0; i < PER; ++i)
        if (FULL || c0 + i < dim) counts += (v[i] & 0x7fffu) ? 1 : 0x10000;
      int incl = counts;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, incl, off);
        if (lane >= off) incl += o;
      }
      const int nz_total = __shfl_sync(kFull, incl, 31) & 0xffff;
      const int before = incl - counts;
      int s_nz = before & 0xffff;                   // first nonzero slot
      int s_zero = nz_total + (before >> 16);       // and first zero slot
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        if (FULL || c0 + i < dim) {
          const int slot = (v[i] & 0x7fffu) ? s_nz++ : s_zero++;
          if (slot < k) {
            s_ch[slot] = c0 + i;
            s_val[slot] = v[i];
          }
        }
      }
      __syncwarp();
      if (vec) {
        uint4* vr = reinterpret_cast<uint4*>(vals + r * k);
        int4* cr = reinterpret_cast<int4*>(ch + r * k);
        for (int j = lane; j < k / 8; j += 32)
          vr[j] = reinterpret_cast<const uint4*>(s_val)[j];
        for (int j = lane; j < k / 4; j += 32)
          cr[j] = reinterpret_cast<const int4*>(s_ch)[j];
      } else {
        for (int j = lane; j < k; j += 32) {
          vals[r * k + j] = s_val[j];
          ch[r * k + j] = s_ch[j];
        }
      }
      __syncwarp();  // the stage is free for the warp's next row
    }
  }
}

// Element types of the densify and sample forms: f32, or bf16 as its bits.
// Widening bf16 -> f32 is exact; narrowing f32 -> bf16 rounds to nearest
// even (cvt.rn, the bits of torch's .to(torch.bfloat16) on the card).
template <typename TO, typename TV>
__device__ __forceinline__ TO convert(TV v);
template <>
__device__ __forceinline__ float convert<float, float>(float v) { return v; }
template <>
__device__ __forceinline__ uint16_t convert<uint16_t, uint16_t>(uint16_t v) {
  return v;
}
template <>
__device__ __forceinline__ float convert<float, uint16_t>(uint16_t v) {
  return __uint_as_float((unsigned)v << 16);
}
template <>
__device__ __forceinline__ uint16_t convert<uint16_t, float>(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// TV: the values' type, TO: the output's (float or uint16_t bf16 bits);
// NV: 16-byte slices per lane, ceil(dim * sizeof(TO) / 512) rounded up to a
// power of two
template <typename TV, typename TO, int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
cbsr_densify_kernel(const TV* __restrict__ vals, const int* __restrict__ ch,
                    TO* __restrict__ out, int64_t n, int k, int dim) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // row is uniform across the warp
  TO* orow = out + row * dim;
  uint4* orow16 = reinterpret_cast<uint4*>(orow);
  const int n16 = dim * (int)sizeof(TO) / 16;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int col = lane + 32 * t;
    if (col < n16) orow16[col] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncwarp();  // the zeros land before the values, lane to lane
  for (int j = lane; j < k; j += 32) {
    const int c = ch[row * k + j];
    if (c >= 0 && c < dim) orow[c] = convert<TO, TV>(vals[row * k + j]);
  }
}

// T: float or uint16_t (bf16 bits); the sampled entries are copied as bits
template <typename T>
__global__ void cbsr_sample_kernel(const T* __restrict__ z,
                                   const int* __restrict__ ch,
                                   T* __restrict__ out, int64_t n, int k,
                                   int dim) {
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n * k) return;
  out[i] = z[(i / k) * dim + ch[i]];
}

unsigned warp_blocks(int64_t rows) {
  return (unsigned)((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <int PER, bool FULL>
void launch_compact16_at(const uint16_t* x, uint16_t* vals, int* ch,
                         int64_t n, int dim, int k, cudaStream_t s) {
  auto kernel = cbsr_compact16_kernel<PER, FULL, kDepthBf16>;
  const int smem = kWarpsPerBlock * stage16_bytes(k);
  static int last_smem = -1, per_sm = 0, sms = 0;  // per instantiation
  if (smem != last_smem) {  // one wave of resident blocks
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  kWarpsPerBlock * 32, smem);
    last_smem = smem;
  }
  const int64_t wave = (int64_t)(per_sm > 0 ? per_sm : 1) * sms;
  const int64_t need = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  kernel<<<(unsigned)(need < wave ? need : wave), kWarpsPerBlock * 32, smem,
           s>>>(x, vals, ch, n, dim, k);
}

template <int PER>
void launch_compact16(const uint16_t* x, uint16_t* vals, int* ch, int64_t n,
                      int dim, int k, cudaStream_t s) {
  if (PER % 2 == 0 && dim == 32 * PER)
    launch_compact16_at<PER, PER % 2 == 0>(x, vals, ch, n, dim, k, s);
  else
    launch_compact16_at<PER, false>(x, vals, ch, n, dim, k, s);
}

template <typename TV, typename TO>
int launch_densify(const void* vals, const void* ch, void* out, int64_t n,
                   int k, int dim, void* stream) {
  // whole 16-byte stores of a row: dim % 4 == 0 (f32 out), % 8 (bf16 out)
  constexpr int per16 = 16 / (int)sizeof(TO);
  if (k < 1 || dim < per16 || dim % per16 != 0 || dim > kMaxDim)
    return (int)cudaErrorInvalidValue;
  const TV* vp = static_cast<const TV*>(vals);
  const int* cp = static_cast<const int*>(ch);
  TO* op = static_cast<TO*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = warp_blocks(n);
  const int threads = kWarpsPerBlock * 32;
  const int nv = (dim / per16 + 31) / 32;
  if (nv <= 1)
    cbsr_densify_kernel<TV, TO, 1><<<blocks, threads, 0, s>>>(vp, cp, op, n,
                                                              k, dim);
  else if (nv <= 2)
    cbsr_densify_kernel<TV, TO, 2><<<blocks, threads, 0, s>>>(vp, cp, op, n,
                                                              k, dim);
  else if (nv <= 4)
    cbsr_densify_kernel<TV, TO, 4><<<blocks, threads, 0, s>>>(vp, cp, op, n,
                                                              k, dim);
  else
    cbsr_densify_kernel<TV, TO, 8><<<blocks, threads, 0, s>>>(vp, cp, op, n,
                                                              k, dim);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sample(const void* z, const void* ch, void* out, int64_t n, int k,
                  int dim, void* stream) {
  if (k < 1 || dim < 1) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n * k + threads - 1) / threads);
  cbsr_sample_kernel<T><<<blocks, threads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(z), static_cast<const int*>(ch),
      static_cast<T*>(out), n, k, dim);
  return (int)cudaGetLastError();
}

}  // namespace

// vals f32 [n, k], ch int32 [n, k] <- the CBSR of x f32 [n, dim].
// Needs 1 <= k <= dim <= 1024.
extern "C" int cbsr_compact(const void* x, void* vals, void* ch, int64_t n,
                            int dim, int k, void* stream) {
  if (dim < 1 || dim > kMaxDim || k < 1 || k > dim)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  float* vp = static_cast<float*>(vals);
  int* cp = static_cast<int*>(ch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned blocks = warp_blocks(n);
  const int threads = kWarpsPerBlock * 32;
  const int nb = (dim + 31) / 32;
  if (nb <= 1)
    cbsr_compact_kernel<1><<<blocks, threads, 0, s>>>(xp, vp, cp, n, dim, k);
  else if (nb <= 2)
    cbsr_compact_kernel<2><<<blocks, threads, 0, s>>>(xp, vp, cp, n, dim, k);
  else if (nb <= 4)
    cbsr_compact_kernel<4><<<blocks, threads, 0, s>>>(xp, vp, cp, n, dim, k);
  else if (nb <= 8)
    cbsr_compact_kernel<8><<<blocks, threads, 0, s>>>(xp, vp, cp, n, dim, k);
  else if (nb <= 16)
    cbsr_compact_kernel<16><<<blocks, threads, 0, s>>>(xp, vp, cp, n, dim, k);
  else
    cbsr_compact_kernel<32><<<blocks, threads, 0, s>>>(xp, vp, cp, n, dim, k);
  return (int)cudaGetLastError();
}

// vals bf16 [n, k], ch int32 [n, k] <- the CBSR of x bf16 [n, dim]: the
// slots of cbsr_compact. Needs 1 <= k <= dim <= 1024 and 16-byte aligned x,
// vals and ch.
extern "C" int cbsr_compact_bf16(const void* x, void* vals, void* ch,
                                 int64_t n, int dim, int k, void* stream) {
  if (dim < 1 || dim > kMaxDim || k < 1 || k > dim)
    return (int)cudaErrorInvalidValue;
  const uint16_t* xp = static_cast<const uint16_t*>(x);
  uint16_t* vp = static_cast<uint16_t*>(vals);
  int* cp = static_cast<int*>(ch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (dim + 31) / 32;
  if (per <= 1) launch_compact16<1>(xp, vp, cp, n, dim, k, s);
  else if (per <= 2) launch_compact16<2>(xp, vp, cp, n, dim, k, s);
  else if (per <= 4) launch_compact16<4>(xp, vp, cp, n, dim, k, s);
  else if (per <= 8) launch_compact16<8>(xp, vp, cp, n, dim, k, s);
  else if (per <= 16) launch_compact16<16>(xp, vp, cp, n, dim, k, s);
  else launch_compact16<32>(xp, vp, cp, n, dim, k, s);
  return (int)cudaGetLastError();
}

// out [n, dim] <- CBSR (vals [n, k], ch int32 [n, k]) made dense, in four
// forms: f32 -> f32, bf16 -> bf16, bf16 -> f32 and f32 -> bf16 (values ->
// output). Needs k >= 1, dim <= 1024, a 16-byte aligned out, and dim % 4 ==
// 0 for an f32 out, dim % 8 == 0 for a bf16 one.
extern "C" int cbsr_densify(const void* vals, const void* ch, void* out,
                            int64_t n, int k, int dim, void* stream) {
  return launch_densify<float, float>(vals, ch, out, n, k, dim, stream);
}

extern "C" int cbsr_densify_bf16(const void* vals, const void* ch, void* out,
                                 int64_t n, int k, int dim, void* stream) {
  return launch_densify<uint16_t, uint16_t>(vals, ch, out, n, k, dim, stream);
}

extern "C" int cbsr_densify_bf16_f32(const void* vals, const void* ch,
                                     void* out, int64_t n, int k, int dim,
                                     void* stream) {
  return launch_densify<uint16_t, float>(vals, ch, out, n, k, dim, stream);
}

extern "C" int cbsr_densify_f32_bf16(const void* vals, const void* ch,
                                     void* out, int64_t n, int k, int dim,
                                     void* stream) {
  return launch_densify<float, uint16_t>(vals, ch, out, n, k, dim, stream);
}

// out [n, k] <- z [n, dim] sampled at ch int32 [n, k], in z's type: f32, or
// bf16 (cbsr_sample_bf16).
extern "C" int cbsr_sample(const void* z, const void* ch, void* out,
                           int64_t n, int k, int dim, void* stream) {
  return launch_sample<float>(z, ch, out, n, k, dim, stream);
}

extern "C" int cbsr_sample_bf16(const void* z, const void* ch, void* out,
                                int64_t n, int k, int dim, void* stream) {
  return launch_sample<uint16_t>(z, ch, out, n, k, dim, stream);
}
