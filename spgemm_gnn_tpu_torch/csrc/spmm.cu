// CSR sparse-dense product y = A_w x for Hopper (sm_90a).
//
// Replaces the TPU kernel spgemm_gnn_tpu/kernels/spgemm_pallas.py::_spmm_kernel
// (call :542, through planned_spmm and kernels/planned.py::planned_aggregate),
// the windowed aggregation that carries the Reddit regime, forward on A and
// backward on the transpose.
//
// Computes y[v] = post[v] * sum_{u in in(v)} pre[u] * x[u]; pre and post are
// optional per-node factors (the separable norms). The backward is this
// kernel on the transpose CSR with pre and post swapped.
//
// Bound on this card: memory. Counting each byte once at Reddit (x and y
// 238.6 MB each, indices 4 B per edge), about 0.94 GB or 0.28 ms at
// 3.35 TB/s; the dense-x FMAs (2 E dim flops) over the 67 TFLOP/s f32 rate
// take about 0.88 ms, so on a dense cotangent the operations bound. But the
// gather reads a whole source row per edge: E dim 4 B, about 117 GB, 35 ms
// from DRAM when no row is reused. Two things kept the first version of this
// kernel (one warp per destination row over the whole CSR) far from that:
// a hub row of 172k edges made its warp the launch's tail, and nothing kept
// the gathered rows in L2.
//
// Design: the TPU kernel's balance (fixed-size edge tiles bucketed by source
// block) in the card's terms. The schedule (graphs/tiles.py::CSRSchedule)
// cuts the source ids into nb blocks whose slab of x fits in half of L2,
// and each (block, row) run of edges into segments of at most S edges,
// listed heaviest first. One pass per block, in block order: every warp of a
// pass gathers from the same slab, which L2 holds, and no warp gathers more
// than S rows. A warp takes one segment: it loads the segment's source ids
// 32 at a time, coalesced and one batch ahead, with their pre factors, and
// walks them through __shfl_sync; each lane owns float4 slices lane + 32 t
// of the row. Rows are fetched into registers ahead of their use, 8 rows at
// dim <= 256 (8 KB in flight per warp at 256). A ring of one-row TMA bulk
// copies (cp.async.bulk) into shared memory was measured against this on the
// H100 and lost (PERF.md): it pays a barrier wait, a fence and a refill per
// row. A whole segment (a run of at most S edges) adds its sum to y[row]
// (the row's first block writes it) and the row's last block multiplies by
// post[row]. A longer run writes each piece's sum to a scratch slot, and a
// fix-up kernel (a warp per split run) adds the slots in order and writes
// the row the same way. Every value has one writer per pass and every sum
// runs in a fixed order: no atomics, and two runs give the same bits. The
// sum is layered: batches of 32 edges on their own, added to the segment's
// sum; pieces in order; blocks in order. One running f32 sum over a 172k-term hub
// row drifted by 1e-5 of the output's largest magnitude; the layers keep it
// near 2e-7 at Reddit (PERF.md).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kFirst = 1;  // graphs/tiles.py::FIRST
constexpr int kLast = 2;   // graphs/tiles.py::LAST

// rows fetched ahead per warp: 8 at NV <= 2 (dim <= 256), then about 8 KB
// per warp
template <int NV>
constexpr int kAhead = NV <= 2 ? 8 : 16 / NV;

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& q) {
  acc.x = fmaf(s, q.x, acc.x);
  acc.y = fmaf(s, q.y, acc.y);
  acc.z = fmaf(s, q.z, acc.z);
  acc.w = fmaf(s, q.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

// A row's sum over one pass goes to y: written on the row's first block,
// else added to what earlier blocks left; scaled by post on its last block.
template <int NV>
__device__ __forceinline__ void store_row(const float4 (&acc)[NV], int row,
                                          int flags,
                                          const float* __restrict__ post,
                                          float4* __restrict__ y, int dim4,
                                          int lane) {
  float4* yr = y + (int64_t)row * dim4;
  const float p = ((flags & kLast) && post != nullptr) ? post[row] : 1.f;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int c = lane + 32 * t;
    if (c < dim4) {
      float4 v = acc[t];
      if (!(flags & kFirst)) {
        float4 old = yr[c];
        add4(old, v);
        v = old;
      }
      if (flags & kLast)
        v = make_float4(v.x * p, v.y * p, v.z * p, v.w * p);
      yr[c] = v;
    }
  }
}

// A segment's sum: a whole run's to y, a piece of a split run's to its slot.
template <int NV>
__device__ __forceinline__ void finish(const float4 (&acc)[NV], int4 s,
                                       const float* __restrict__ post,
                                       float4* __restrict__ y,
                                       float4* __restrict__ scratch, int dim4,
                                       int lane) {
  if (s.w < 0) {
    store_row<NV>(acc, s.x, -1 - s.w, post, y, dim4, lane);
    return;
  }
  float4* out = scratch + (int64_t)s.w * dim4;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int c = lane + 32 * t;
    if (c < dim4) out[c] = acc[t];
  }
}

// One warp per segment (row, lo, hi, out), rows fetched kAhead ahead into
// registers. NV: float4 slices per lane, ceil(dim / 128) rounded up to a
// power of two.
template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_segment_kernel(const int4* __restrict__ seg, int64_t n_seg,
                   const int* __restrict__ indices,
                   const float4* __restrict__ x, const float* __restrict__ pre,
                   const float* __restrict__ post, float4* __restrict__ y,
                   float4* __restrict__ scratch, int dim4) {
  constexpr int D = kAhead<NV>;
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_seg) return;  // i is uniform across the warp
  const int4 s = seg[i];

  float4 acc[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  // a batch's source ids are loaded one batch ahead
  int un = s.y + lane < s.z ? indices[s.y + lane] : 0;
  for (int base = s.y; base < s.z; base += 32) {
    const int u = un;
    un = base + 32 + lane < s.z ? indices[base + 32 + lane] : 0;
    const float sc = (pre != nullptr && base + lane < s.z) ? pre[u] : 1.f;
    const int cnt = min(32, s.z - base);
    float4 part[NV];  // this batch's sum
#pragma unroll
    for (int t = 0; t < NV; ++t) part[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < cnt; j += D) {  // D divides 32: j + d < 32
      float4 q[D][NV];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int ud = __shfl_sync(kFull, u, j + d);
        if (j + d < cnt) {
          const float4* xr = x + (int64_t)ud * dim4;
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            const int c = lane + 32 * t;
            if (c < dim4) q[d][t] = __ldg(xr + c);
          }
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const float sd = __shfl_sync(kFull, sc, j + d);
        if (j + d < cnt) {
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            const int c = lane + 32 * t;
            if (c < dim4) fma4(part[t], sd, q[d][t]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < NV; ++t) add4(acc[t], part[t]);
  }
  finish<NV>(acc, s, post, y, scratch, dim4, lane);
}

// One warp per split run (row, slot_lo, slot_hi, flags): its pieces' sums in
// order, then to y as a whole segment's.
template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_fixup_kernel(const int4* __restrict__ fix, int64_t n_fix,
                 const float* __restrict__ post,
                 const float4* __restrict__ scratch, float4* __restrict__ y,
                 int dim4) {
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_fix) return;  // i is uniform across the warp
  const int4 f = fix[i];
  float4 acc[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int c = lane + 32 * t;
    acc[t] = c < dim4 ? scratch[(int64_t)f.y * dim4 + c]
                      : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int q = f.y + 1; q < f.z; ++q) {
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int c = lane + 32 * t;
      if (c < dim4) add4(acc[t], scratch[(int64_t)q * dim4 + c]);
    }
  }
  store_row<NV>(acc, f.x, f.w, post, y, dim4, lane);
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <int NV>
int run(const int4* seg, const int4* fix, const int64_t* pass_seg,
        const int64_t* pass_fix, int nb, const int* indices, const float4* x,
        const float* pre, const float* post, float4* y, float4* scratch,
        int dim4, cudaStream_t s) {
  for (int b = 0; b < nb; ++b) {
    const int64_t n_seg = pass_seg[b + 1] - pass_seg[b];
    if (n_seg > 0) {
      csr_segment_kernel<NV><<<blocks_for(n_seg), kWarpsPerBlock * 32, 0, s>>>(
          seg + pass_seg[b], n_seg, indices, x, pre, post, y, scratch, dim4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int64_t n_fix = pass_fix[b + 1] - pass_fix[b];
    if (n_fix > 0) {
      csr_fixup_kernel<NV><<<blocks_for(n_fix), kWarpsPerBlock * 32, 0, s>>>(
          fix + pass_fix[b], n_fix, post, scratch, y, dim4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// y <- post * (A (pre * x)) over a schedule (graphs/tiles.py::CSRSchedule):
// seg int32 [n_seg, 4] and fix int32 [n_fix, 4] on the device, pass_seg and
// pass_fix int64 [nb + 1] on the host, indices int32 [E] (re-bucketed); x
// f32 [n_src, dim], y f32 [n_rows, dim], scratch f32 [n_slots, dim] (or
// null without split runs), pre f32 [n_src] or null, post f32 [n_rows] or
// null. Needs dim % 4 == 0, dim <= 1024 and 16-byte aligned x, y and
// scratch.
extern "C" int csr_spmm(const void* seg, const void* fix, const void* pass_seg,
                        const void* pass_fix, int nb, const void* indices,
                        const void* x, const void* pre, const void* post,
                        void* y, void* scratch, int dim, void* stream) {
  if (dim < 4 || dim % 4 != 0 || dim > 1024 || nb < 1)
    return (int)cudaErrorInvalidValue;
  const int dim4 = dim / 4;
  const int4* sp = static_cast<const int4*>(seg);
  const int4* fp = static_cast<const int4*>(fix);
  const int64_t* ps = static_cast<const int64_t*>(pass_seg);
  const int64_t* pf = static_cast<const int64_t*>(pass_fix);
  const int* ix = static_cast<const int*>(indices);
  const float4* xp = static_cast<const float4*>(x);
  const float* pp = static_cast<const float*>(pre);
  const float* qp = static_cast<const float*>(post);
  float4* yp = static_cast<float4*>(y);
  float4* sc = static_cast<float4*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nv = (dim4 + 31) / 32;
  if (nv <= 1)
    return run<1>(sp, fp, ps, pf, nb, ix, xp, pp, qp, yp, sc, dim4, s);
  if (nv <= 2)
    return run<2>(sp, fp, ps, pf, nb, ix, xp, pp, qp, yp, sc, dim4, s);
  if (nv <= 4)
    return run<4>(sp, fp, ps, pf, nb, ix, xp, pp, qp, yp, sc, dim4, s);
  return run<8>(sp, fp, ps, pf, nb, ix, xp, pp, qp, yp, sc, dim4, s);
}
