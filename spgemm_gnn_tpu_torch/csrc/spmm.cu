// CSR sparse-dense product y = A_w x for Hopper (sm_90a).
//
// Replaces the TPU kernel spgemm_gnn_tpu/kernels/spgemm_pallas.py::_spmm_kernel
// (through planned_spmm and kernels/planned.py::planned_aggregate), the
// windowed aggregation that carries the Reddit regime, forward on A and
// backward on the transpose.
//
// Computes y[v] = post[v] * sum_{u in in(v)} pre[u] * x[u] over (indptr,
// indices); pre and post are optional per-node factors (the separable norms).
// The backward is this kernel on the transpose CSR with pre and post swapped.
//
// Bound on this card: memory. Counting each byte once at Reddit (x and y
// 238.6 MB each, indices 4 B per edge), about 0.94 GB or 0.28 ms at
// 3.35 TB/s; the dense-x FMAs (2 E dim flops) over the 67 TFLOP/s f32 rate
// take about 0.88 ms, so on a dense cotangent the operations bound. But the
// gather reads a whole source row per edge: E dim 4 B, about 117 GB or 35 ms
// when L2 catches no reuse. That traffic, not the bound, is what this simple
// kernel pays.
//
// Design: one warp per destination row, 8 rows per block. The TPU's tile
// plan, slab gather, one-hot MXU scatter and [dim, N] transpose exist only for
// Mosaic and are not carried over. Neighbour ids load 32 at a time, coalesced,
// with their pre factors, and go to the lanes by __shfl_sync; each lane owns
// float4 slices lane + 32 t of the row, so every row gather is one coalesced
// 16-byte load per lane per slice. Sums stay in f32 registers in CSR order:
// no atomics, and the result is deterministic. Each batch of 32 neighbours
// is summed on its own and then added to the row's total: one running f32
// sum over a hub row of 172k neighbours drifts by about 1e-5 of the output's
// largest magnitude, the two-level sum by several times less, for one add
// per batch. A hub row (power-law degree) makes its warp the tail of the
// launch; that is a known limit here.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

// NV: float4 slices per lane, ceil(dim / 128) rounded up to a power of two
template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_spmm_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const float4* __restrict__ x, const float* __restrict__ pre,
                const float* __restrict__ post, float4* __restrict__ y,
                int64_t n_rows, int dim4) {
  const int lane = threadIdx.x & 31;
  const int64_t row =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;  // row is uniform across the warp
  const int start = indptr[row];
  const int end = indptr[row + 1];

  float4 acc[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int base = start; base < end; base += 32) {
    int u = 0;
    float s = 1.f;
    if (base + lane < end) {
      u = indices[base + lane];
      if (pre != nullptr) s = pre[u];
    }
    const int cnt = min(32, end - base);
    float4 part[NV];  // this batch's sum
#pragma unroll
    for (int t = 0; t < NV; ++t) part[t] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int j = 0; j < cnt; ++j) {
      const int uj = __shfl_sync(kFull, u, j);
      const float sj = __shfl_sync(kFull, s, j);
      const float4* xr = x + (int64_t)uj * dim4;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int c = lane + 32 * t;
        if (c < dim4) {
          const float4 q = __ldg(xr + c);
          part[t].x = fmaf(sj, q.x, part[t].x);
          part[t].y = fmaf(sj, q.y, part[t].y);
          part[t].z = fmaf(sj, q.z, part[t].z);
          part[t].w = fmaf(sj, q.w, part[t].w);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      acc[t].x += part[t].x;
      acc[t].y += part[t].y;
      acc[t].z += part[t].z;
      acc[t].w += part[t].w;
    }
  }

  const float p = post != nullptr ? post[row] : 1.f;
  float4* yr = y + row * dim4;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int c = lane + 32 * t;
    if (c < dim4)
      yr[c] = make_float4(acc[t].x * p, acc[t].y * p, acc[t].z * p,
                          acc[t].w * p);
  }
}

template <int NV>
void launch(const int* indptr, const int* indices, const float4* x,
            const float* pre, const float* post, float4* y, int64_t n_rows,
            int dim4, cudaStream_t s) {
  const unsigned blocks =
      (unsigned)((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  csr_spmm_kernel<NV><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
      indptr, indices, x, pre, post, y, n_rows, dim4);
}

}  // namespace

// y <- post * (A (pre * x)) over the CSR (indptr int32 [n_rows + 1], indices
// int32 [E]); x f32 [n_src, dim], y f32 [n_rows, dim], pre f32 [n_src] or
// null, post f32 [n_rows] or null. Needs dim % 4 == 0, dim <= 1024 and
// 16-byte aligned x and y.
extern "C" int csr_spmm(const void* indptr, const void* indices, const void* x,
                        const void* pre, const void* post, void* y,
                        int64_t n_rows, int dim, void* stream) {
  if (dim < 4 || dim % 4 != 0 || dim > 1024) return (int)cudaErrorInvalidValue;
  const int dim4 = dim / 4;
  const int* ip = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const float4* xp = static_cast<const float4*>(x);
  const float* pp = static_cast<const float*>(pre);
  const float* qp = static_cast<const float*>(post);
  float4* yp = static_cast<float4*>(y);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nv = (dim4 + 31) / 32;
  if (nv <= 1) launch<1>(ip, ix, xp, pp, qp, yp, n_rows, dim4, s);
  else if (nv <= 2) launch<2>(ip, ix, xp, pp, qp, yp, n_rows, dim4, s);
  else if (nv <= 4) launch<4>(ip, ix, xp, pp, qp, yp, n_rows, dim4, s);
  else launch<8>(ip, ix, xp, pp, qp, yp, n_rows, dim4, s);
  return (int)cudaGetLastError();
}
