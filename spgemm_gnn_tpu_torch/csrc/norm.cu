// Layer norm of bf16 rows for Hopper (sm_90a): the 16-bit model's LayerNorm
// (--dtype bfloat16), forward and backward.
//
// In the JAX package this is XLA glue, not a Pallas kernel: flax
// LayerNorm(dtype=bfloat16) takes the statistics in f32, computes
// y = (x - mean) * (rsqrt(var + eps) * scale) + bias in f32 with f32
// parameters and rounds y once to bf16 (flax `_normalize` with
// force_float32_reductions). Its plain version, ops/layernorm.py, is that
// arithmetic in PyTorch ops: seven passes over [N, dim] f32 temporaries in
// the forward and about fifteen in the backward, which took 130 of the 329 ms
// of an ogbn-products train step on an H100 (profile_step, 3 layers).
//
// Forward, one warp per row: the row in registers (a lane holds a contiguous
// range of PER channels, loaded as 32-bit or wider words), mean and variance
// by two warp sums (the variance of the centred values), then y with the
// product (rstd * scale) formed first and no contraction into an FMA, as the
// reference computes it; mean and rstd are kept per row for the backward.
// Backward, one warp per row over a fixed grid: xhat = (x - mean) * rstd,
// gx = g * scale, dx = rstd * (gx - mean(gx) - xhat * mean(gx * xhat)) in
// f32, rounded once to bf16; each lane sums g * xhat and g for its channels
// over the warp's rows, and each block writes its warps' sums to a row of
// partial sums, which the caller adds over blocks (no atomics: two runs give
// the same bits).
//
// Bound on this card: memory. At ogbn-products (N = 2,449,029, dim 256) the
// forward reads 1.25 GB and writes 1.27 GB, about 0.75 ms at 3.35 TB/s; the
// backward reads 2.5 GB and writes 1.25 GB, about 1.1 ms.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kBwdBlocks = 1024;  // the backward's grid: rows of partials
constexpr int kMaxDim = 1024;     // a row in one warp: 32 lanes x 32 values

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// A lane's PER channels of a bf16 row, widened; FULL: dim == 32 * PER with
// PER even (whole words, 16 B at dim 256), else element by element.
template <int PER, bool FULL>
__device__ __forceinline__ void load16(const uint16_t* p, int valid,
                                       float (&v)[PER]) {
  if constexpr (FULL) {
    constexpr int NW = PER / 2;
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
    for (int j = 0; j < NW; ++j) {
      v[2 * j] = __uint_as_float(w[j] << 16);
      v[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < PER; ++i)
      v[i] = i < valid ? __uint_as_float((unsigned)p[i] << 16) : 0.f;
  }
}

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// v rounded to bf16 (nearest even) into the lane's range
template <int PER, bool FULL>
__device__ __forceinline__ void store16(uint16_t* p, int valid,
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
      if (i < valid) p[i] = __bfloat16_as_ushort(__float2bfloat16_rn(v[i]));
  }
}

template <int PER, bool FULL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm16_fwd_kernel(const uint16_t* __restrict__ x,
                        const float* __restrict__ scale,
                        const float* __restrict__ bias,
                        uint16_t* __restrict__ y, float* __restrict__ mean,
                        float* __restrict__ rstd, int64_t n, int dim,
                        float eps) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // row is uniform across the warp
  const int c0 = lane * PER;
  const int valid = dim - c0;
  float v[PER];
  load16<PER, FULL>(x + row * dim + c0, valid, v);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) s += v[i];
  const float mu = warp_sum(s) / dim;
  float q = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const float d = i < valid ? v[i] - mu : 0.f;
    q = fmaf(d, d, q);
  }
  const float r = rsqrtf(warp_sum(q) / dim + eps);
  float out[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = min(c0 + i, dim - 1);
    // (x - mean) * (rstd * scale) + bias, each operation rounded
    out[i] = __fadd_rn(__fmul_rn(__fsub_rn(v[i], mu), __fmul_rn(r, scale[c])),
                       bias[c]);
  }
  store16<PER, FULL>(y + row * dim + c0, valid, out);
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = r;
  }
}

// dx, and the block's sums of g * xhat (dscale) and g (dbias) into row
// blockIdx.x of the partials [gridDim.x, dim]
template <int PER, bool FULL>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm16_bwd_kernel(const uint16_t* __restrict__ x,
                        const uint16_t* __restrict__ g,
                        const float* __restrict__ mean,
                        const float* __restrict__ rstd,
                        const float* __restrict__ scale,
                        uint16_t* __restrict__ dx,
                        float* __restrict__ dscale_part,
                        float* __restrict__ dbias_part, int64_t n, int dim) {
  __shared__ float red[kWarpsPerBlock][32 * PER];  // 32 KB at PER 32
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = lane * PER;
  const int valid = dim - c0;
  float w[PER], ds[PER], db[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    w[i] = scale[min(c0 + i, dim - 1)];
    ds[i] = 0.f;
    db[i] = 0.f;
  }
  const int64_t warps = (int64_t)gridDim.x * kWarpsPerBlock;
  for (int64_t row = (int64_t)blockIdx.x * kWarpsPerBlock + warp; row < n;
       row += warps) {
    float xv[PER], gv[PER];
    load16<PER, FULL>(x + row * dim + c0, valid, xv);
    load16<PER, FULL>(g + row * dim + c0, valid, gv);
    const float mu = mean[row], r = rstd[row];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      xv[i] = (xv[i] - mu) * r;  // xhat (0 past the row: gv is 0 there)
      const float gx = gv[i] * w[i];
      s1 += gx;
      s2 = fmaf(gx, xv[i], s2);
      ds[i] = fmaf(gv[i], xv[i], ds[i]);
      db[i] += gv[i];
    }
    const float m1 = warp_sum(s1) / dim;
    const float m2 = warp_sum(s2) / dim;
    float out[PER];
#pragma unroll
    for (int i = 0; i < PER; ++i)
      out[i] = r * (gv[i] * w[i] - m1 - xv[i] * m2);
    store16<PER, FULL>(dx + row * dim + c0, valid, out);
  }
  // the block's sum over its warps, in warp order: dscale, then dbias
  for (int pass = 0; pass < 2; ++pass) {
#pragma unroll
    for (int i = 0; i < PER; ++i) red[warp][c0 + i] = pass ? db[i] : ds[i];
    __syncthreads();
    float* part =
        (pass ? dbias_part : dscale_part) + (int64_t)blockIdx.x * dim;
    for (int c = threadIdx.x; c < dim; c += blockDim.x) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < kWarpsPerBlock; ++k) a += red[k][c];
      part[c] = a;
    }
    __syncthreads();
  }
}

template <int PER>
void launch_fwd(const uint16_t* x, const float* scale, const float* bias,
                uint16_t* y, float* mean, float* rstd, int64_t n, int dim,
                float eps, cudaStream_t s) {
  const unsigned blocks = (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
  if (PER % 2 == 0 && dim == 32 * PER)
    layer_norm16_fwd_kernel<PER, PER % 2 == 0><<<blocks, kWarpsPerBlock * 32,
                                                 0, s>>>(
        x, scale, bias, y, mean, rstd, n, dim, eps);
  else
    layer_norm16_fwd_kernel<PER, false><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        x, scale, bias, y, mean, rstd, n, dim, eps);
}

template <int PER>
void launch_bwd(const uint16_t* x, const uint16_t* g, const float* mean,
                const float* rstd, const float* scale, uint16_t* dx,
                float* dsp, float* dbp, int64_t n, int dim, cudaStream_t s) {
  if (PER % 2 == 0 && dim == 32 * PER)
    layer_norm16_bwd_kernel<PER, PER % 2 == 0>
        <<<kBwdBlocks, kWarpsPerBlock * 32, 0, s>>>(x, g, mean, rstd, scale,
                                                    dx, dsp, dbp, n, dim);
  else
    layer_norm16_bwd_kernel<PER, false>
        <<<kBwdBlocks, kWarpsPerBlock * 32, 0, s>>>(x, g, mean, rstd, scale,
                                                    dx, dsp, dbp, n, dim);
}

}  // namespace

// y bf16 [n, dim], mean and rstd f32 [n] <- the layer norm of x bf16
// [n, dim] with scale and bias f32 [dim]. Needs 1 <= dim <= 1024 and a
// 16-byte aligned x and y.
extern "C" int layer_norm16_fwd(const void* x, const void* scale,
                                const void* bias, void* y, void* mean,
                                void* rstd, int64_t n, int dim, float eps,
                                void* stream) {
  if (dim < 1 || dim > kMaxDim) return (int)cudaErrorInvalidValue;
  const uint16_t* xp = static_cast<const uint16_t*>(x);
  const float* sp = static_cast<const float*>(scale);
  const float* bp = static_cast<const float*>(bias);
  uint16_t* yp = static_cast<uint16_t*>(y);
  float* mp = static_cast<float*>(mean);
  float* rp = static_cast<float*>(rstd);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (dim + 31) / 32;
  if (per <= 1) launch_fwd<1>(xp, sp, bp, yp, mp, rp, n, dim, eps, s);
  else if (per <= 2) launch_fwd<2>(xp, sp, bp, yp, mp, rp, n, dim, eps, s);
  else if (per <= 4) launch_fwd<4>(xp, sp, bp, yp, mp, rp, n, dim, eps, s);
  else if (per <= 8) launch_fwd<8>(xp, sp, bp, yp, mp, rp, n, dim, eps, s);
  else if (per <= 16) launch_fwd<16>(xp, sp, bp, yp, mp, rp, n, dim, eps, s);
  else launch_fwd<32>(xp, sp, bp, yp, mp, rp, n, dim, eps, s);
  return (int)cudaGetLastError();
}

// dx bf16 [n, dim], and per block of the grid the sums of g * xhat and of g
// (dscale_part, dbias_part f32 [layer_norm16_bwd_blocks(), dim]) <- x and g
// bf16 [n, dim], mean and rstd f32 [n] from layer_norm16_fwd, scale f32
// [dim]. Needs 1 <= dim <= 1024 and 16-byte aligned x, g and dx.
extern "C" int layer_norm16_bwd(const void* x, const void* g,
                                const void* mean, const void* rstd,
                                const void* scale, void* dx,
                                void* dscale_part, void* dbias_part,
                                int64_t n, int dim, void* stream) {
  if (dim < 1 || dim > kMaxDim) return (int)cudaErrorInvalidValue;
  const uint16_t* xp = static_cast<const uint16_t*>(x);
  const uint16_t* gp = static_cast<const uint16_t*>(g);
  const float* mp = static_cast<const float*>(mean);
  const float* rp = static_cast<const float*>(rstd);
  const float* sp = static_cast<const float*>(scale);
  uint16_t* dp = static_cast<uint16_t*>(dx);
  float* dsp = static_cast<float*>(dscale_part);
  float* dbp = static_cast<float*>(dbias_part);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per = (dim + 31) / 32;
  if (per <= 1) launch_bwd<1>(xp, gp, mp, rp, sp, dp, dsp, dbp, n, dim, s);
  else if (per <= 2) launch_bwd<2>(xp, gp, mp, rp, sp, dp, dsp, dbp, n, dim, s);
  else if (per <= 4) launch_bwd<4>(xp, gp, mp, rp, sp, dp, dsp, dbp, n, dim, s);
  else if (per <= 8) launch_bwd<8>(xp, gp, mp, rp, sp, dp, dsp, dbp, n, dim, s);
  else if (per <= 16)
    launch_bwd<16>(xp, gp, mp, rp, sp, dp, dsp, dbp, n, dim, s);
  else launch_bwd<32>(xp, gp, mp, rp, sp, dp, dsp, dbp, n, dim, s);
  return (int)cudaGetLastError();
}

// rows of partial sums that layer_norm16_bwd writes
extern "C" int layer_norm16_bwd_blocks() { return kBwdBlocks; }
