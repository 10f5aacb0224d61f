// Rounds per-node-scaled rows to bf16, y = bf16(pre * x), for Hopper
// (sm_90a): the messages of the 16-bit feature stream ("bf16x2").
//
// In the JAX package this is XLA glue, not a Pallas kernel: the node factor
// scales x in f32 (kernels/planned.py::_scale) and the stream rounds the
// result to bf16 (spgemm_pallas.py::_pack_bf16x2, stream_pallas.py:227-228,
// :158-159). The bf16 forms of csr_spmm, stream_spmm and stream_cbsr_spmm
// gather these rows, so the rounding point is (pre * x), not x: a kernel that
// rounded x and applied pre per edge would differ by one rounding.
//
// Computes y[r, c] = bf16_rn(pre[r] * x[r, c]) for x f32 [n, w], pre f32 [n]
// or null; the f32 product is rounded once (round to nearest even), so the
// bits are those of torch's `(x * pre[:, None]).to(torch.bfloat16)`.
//
// Bound on this card: memory. At ogbn-products (n 2,449,029, w 256) it reads
// 2.5 GB and writes 1.25 GB, about 1.1 ms at 3.35 TB/s. One fused pass, so
// the scaled f32 rows never exist in device memory: two float4 loads and one
// 16-byte store per thread where w % 8 == 0, one element per thread
// otherwise (the CBSR values at a k that is not a multiple of 8).
//
// round_out, the second export, is the bf16 output of csr_spmm_bf16_out (the
// 16-bit model, --dtype bfloat16): y16 = bf16(bf16(y) * bf16(post)) from the
// f32 sums y of csr_spmm_bf16 run with no post, the reference's two
// roundings (spgemm_gnn_tpu/kernels/planned.py:300, then :323; the product
// of two bf16 values is exact in f32). csr_spmm keeps its sums in an f32 y
// across its source-block passes anyway, so the rounding is one pass over
// that y: at Reddit (n 232,965, w 256) it reads 239 MB and writes 119 MB,
// about 0.11 ms at 3.35 TB/s. (Rounding inside the product's last pass
// instead read 9.78 ms against the f32 product's 8.52 on an H100.)

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ unsigned pack2(float a, float b) {
  // .x (channel 2i, the low half of the word) from a, .y from b
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// one thread per 8 channels of a row (w8 = w / 8 per row)
__global__ void __launch_bounds__(kThreads)
round_rows8_kernel(const float4* __restrict__ x, const float* __restrict__ pre,
                   uint4* __restrict__ y, int64_t n8, int w8) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n8) return;
  const float p = pre != nullptr ? __ldg(pre + i / w8) : 1.f;
  const float4 a = __ldcs(x + 2 * i);
  const float4 b = __ldcs(x + 2 * i + 1);
  uint4 o;
  o.x = pack2(__fmul_rn(a.x, p), __fmul_rn(a.y, p));
  o.y = pack2(__fmul_rn(a.z, p), __fmul_rn(a.w, p));
  o.z = pack2(__fmul_rn(b.x, p), __fmul_rn(b.y, p));
  o.w = pack2(__fmul_rn(b.z, p), __fmul_rn(b.w, p));
  __stcs(y + i, o);
}

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// one thread per 8 channels of a row: y16 = bf16(bf16(y) * p), p = bf16(post)
__global__ void __launch_bounds__(kThreads)
round_out8_kernel(const float4* __restrict__ y, const float* __restrict__ post,
                  uint4* __restrict__ y16, int64_t n8, int w8) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n8) return;
  const float p = post != nullptr ? bf16_round(__ldg(post + i / w8)) : 1.f;
  const float4 a = __ldcs(y + 2 * i);
  const float4 b = __ldcs(y + 2 * i + 1);
  uint4 o;
  o.x = pack2(bf16_round(a.x) * p, bf16_round(a.y) * p);
  o.y = pack2(bf16_round(a.z) * p, bf16_round(a.w) * p);
  o.z = pack2(bf16_round(b.x) * p, bf16_round(b.y) * p);
  o.w = pack2(bf16_round(b.z) * p, bf16_round(b.w) * p);
  __stcs(y16 + i, o);
}

// one thread per element
__global__ void __launch_bounds__(kThreads)
round_rows1_kernel(const float* __restrict__ x, const float* __restrict__ pre,
                   __nv_bfloat16* __restrict__ y, int64_t n, int w) {
  const int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  const float p = pre != nullptr ? __ldg(pre + i / w) : 1.f;
  y[i] = __float2bfloat16_rn(__fmul_rn(x[i], p));
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// y <- bf16(pre * x): x f32 [n_rows, width], pre f32 [n_rows] or null, y bf16
// [n_rows, width]; x and y 16-byte aligned when width % 8 == 0.
extern "C" int round_rows(const void* x, const void* pre, void* y,
                          int64_t n_rows, int width, void* stream) {
  if (n_rows < 0 || width < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* pp = static_cast<const float*>(pre);
  if (width % 8 == 0) {
    const int64_t n8 = n_rows * (width / 8);
    if (n8 > 0)
      round_rows8_kernel<<<blocks_for(n8), kThreads, 0, s>>>(
          static_cast<const float4*>(x), pp, static_cast<uint4*>(y), n8,
          width / 8);
  } else {
    const int64_t n = n_rows * width;
    if (n > 0)
      round_rows1_kernel<<<blocks_for(n), kThreads, 0, s>>>(
          static_cast<const float*>(x), pp,
          static_cast<__nv_bfloat16*>(y), n, width);
  }
  return (int)cudaGetLastError();
}

// y16 <- bf16(bf16(y) * bf16(post)): y f32 [n_rows, width], post f32
// [n_rows] or null, y16 bf16 [n_rows, width]. Needs width % 8 == 0 and
// 16-byte aligned y and y16.
extern "C" int round_out(const void* y, const void* post, void* y16,
                         int64_t n_rows, int width, void* stream) {
  if (n_rows < 0 || width < 8 || width % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const int64_t n8 = n_rows * (width / 8);
  if (n8 > 0)
    round_out8_kernel<<<blocks_for(n8), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float4*>(y), static_cast<const float*>(post),
        static_cast<uint4*>(y16), n8, width / 8);
  return (int)cudaGetLastError();
}
