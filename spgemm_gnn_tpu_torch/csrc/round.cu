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
