// Sparse-dense product y = A_w x over fixed-size edge chunks, for Hopper
// (sm_90a): the low-degree regime.
//
// Replaces the TPU kernel spgemm_gnn_tpu/kernels/stream_pallas.py::
// _stream_kernel (through stream_spmm and kernels/planned.py::
// planned_aggregate), the aggregation of StreamPlan graphs (flickr, yelp,
// ogbn-products), forward on A and backward on the transpose.
//
// Computes y[v] = post[v] * sum_{u in in(v)} pre[u] * x[u] over the CSR
// (indptr, indices) cut into chunks of `chunk` consecutive edges
// (graphs/stream_tiles.py::StreamPlan); pre and post are optional per-node
// factors (the separable norms). The TPU kernel reduced edge messages that
// XLA had gathered into an [E, dim] buffer; here the gather is fused in and
// no message buffer exists.
//
// Bound on this card: memory. Counting each byte once at ogbn-products
// (N = 2,449,029, dim 256: x and y 2.5 GB each, indices 4 B per edge), about
// 5.5 GB or 1.6 ms at 3.35 TB/s. But the gather reads a whole source row per
// edge: E dim 4 B, about 127 GB or 38 ms when L2 catches no reuse. That
// traffic is what this simple kernel pays.
//
// Design: one warp per chunk, 8 chunks per block, so every warp does the
// same number of gathers whatever the degrees; a hub row is spread over as
// many warps as it has chunks. The warp stages its chunk's source ids and pre
// factors in shared memory, then walks the chunk's rows from chunk_row0 and
// sums each row's segment in f32 registers, float4 slices lane + 32 t per
// lane as in csr_spmm. A row that starts and ends in the chunk is written
// whole. A row's first segment, where the row goes on past the chunk, is
// written into y unscaled; a chunk's first segment, where its row began in an
// earlier chunk, goes to the chunk's carry slot. A second kernel takes one
// warp per carry row (StreamPlan.carry_rows): an empty row comes out 0, a row
// across chunks adds its carry slots to y in chunk order and takes its post
// factor. Each value has one writer per pass and the sums run in a fixed
// order: no atomics, and two runs give the same bits. A row's sum is
// two-level (within a chunk, then across chunks), which keeps a hub row's f32
// error near csr_spmm's batched sum.
//
// stream_cbsr_spmm, the second export, replaces the TPU kernel
// spgemm_gnn_tpu/kernels/stream_pallas.py::_stream_cbsr_kernel (through
// stream_spmm_cbsr and kernels/planned.py, behind STREAM_CBSR_FORWARD): the
// same forward product on a k-sparse input given as CBSR, so that per edge
// the gather reads k values and ceil(k/4) packed channel words (160 B at
// k = 32) instead of a dense row of dim floats (1 KB at dim 256). The TPU
// kernel densified each gathered tile by k one-hot steps and reduced it on
// the MXU; here each warp scatters its edges' values into a dense row
// accumulator in shared memory and keeps stream_spmm's walk, row rules and
// carry pass. Bound on this card: memory. At ogbn-products (k 32, dim 256)
// each byte once is about 3.4 GB (y alone 2.5 GB), 1.0 ms at 3.35 TB/s; with
// no reuse of the gathered rows E * 164 B, about 20 GB or 6 ms. Skipped
// channels hold zeros, and adding a zero product to a sum that started at
// +0 leaves it as it is, so y equals stream_spmm's y on the densified input
// by value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& q) {
  acc.x = fmaf(s, q.x, acc.x);
  acc.y = fmaf(s, q.y, acc.y);
  acc.z = fmaf(s, q.z, acc.z);
  acc.w = fmaf(s, q.w, acc.w);
}

// NV: float4 slices per lane, ceil(dim / 128) rounded up to a power of two
template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stream_chunk_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ indices,
                    const float4* __restrict__ x, const float* __restrict__ pre,
                    const float* __restrict__ post,
                    const int* __restrict__ chunk_row0,
                    float4* __restrict__ y, float4* __restrict__ carry,
                    int64_t n_chunks, int64_t n_edges, int chunk, int dim4) {
  extern __shared__ int smem[];  // [warps][chunk] ids, then [warps][chunk] pre
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (c >= n_chunks) return;  // c is uniform across the warp
  int* s_id = smem + warp * chunk;
  float* s_pre =
      reinterpret_cast<float*>(smem + kWarpsPerBlock * chunk) + warp * chunk;
  const int64_t lo = c * chunk;
  const int64_t hi = min(lo + chunk, n_edges);
  for (int i = lane; i < hi - lo; i += 32) {
    const int u = indices[lo + i];
    s_id[i] = u;
    s_pre[i] = pre != nullptr ? pre[u] : 1.f;
  }
  __syncwarp();

  int64_t r = chunk_row0[c];
  int64_t e = lo;
  while (e < hi) {
    const int64_t rs = indptr[r];
    const int64_t re = indptr[r + 1];
    if (rs == re) {  // no edges: the carry pass writes the row
      ++r;
      continue;
    }
    const int64_t end = min(re, hi);
    float4 acc[NV];
#pragma unroll
    for (int t = 0; t < NV; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (; e < end; ++e) {
      const int j = (int)(e - lo);
      const float4* xr = x + (int64_t)s_id[j] * dim4;
      const float s = s_pre[j];
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int col = lane + 32 * t;
        if (col < dim4) fma4(acc[t], s, __ldg(xr + col));
      }
    }
    float4* out;
    float p = 1.f;
    if (rs < lo) {
      out = carry + c * dim4;  // the row began in an earlier chunk
    } else {
      out = y + r * dim4;
      if (re <= hi && post != nullptr) p = post[r];  // else: goes on, unscaled
    }
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = lane + 32 * t;
      if (col < dim4)
        out[col] = make_float4(acc[t].x * p, acc[t].y * p, acc[t].z * p,
                               acc[t].w * p);
    }
    ++r;
  }
}

template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stream_carry_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ carry_rows,
                    const float* __restrict__ post,
                    const float4* __restrict__ carry, float4* __restrict__ y,
                    int64_t n_carry, int chunk, int dim4) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_carry) return;  // i is uniform across the warp
  const int64_t r = carry_rows[i];
  const int64_t a = indptr[r];
  const int64_t b = indptr[r + 1];
  float4* yr = y + r * dim4;
  float4 acc[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int col = lane + 32 * t;
    acc[t] = (a < b && col < dim4) ? yr[col] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  if (a < b) {
    const int64_t last = (b - 1) / chunk;
#pragma unroll 4
    for (int64_t q = a / chunk + 1; q <= last; ++q) {
      const float4* cq = carry + q * dim4;
#pragma unroll
      for (int t = 0; t < NV; ++t) {
        const int col = lane + 32 * t;
        if (col < dim4) {
          const float4 v = cq[col];
          acc[t].x += v.x;
          acc[t].y += v.y;
          acc[t].z += v.z;
          acc[t].w += v.w;
        }
      }
    }
  }
  const float p = (a < b && post != nullptr) ? post[r] : 1.f;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int col = lane + 32 * t;
    if (col < dim4)
      yr[col] = make_float4(acc[t].x * p, acc[t].y * p, acc[t].z * p,
                            acc[t].w * p);
  }
}

// The CBSR edge-gather chunk pass (stream_cbsr_spmm): the walk, the row
// rules and the summation order of stream_chunk_kernel, with the input given
// per node as k values and k channel ids packed four to an int32 word
// (uint8 ids, so dim <= 256). Per edge, lane j takes slots j, j + 32, ...:
// it reads values[u][j] (one 128-byte line per edge at k = 32) and byte
// j % 4 of word j / 4, and adds pre[u] * v into the warp's dense row
// accumulator of dim floats in shared memory at that channel. The k channels
// of a row are distinct, so no two lanes touch one address within an edge;
// a __syncwarp orders one edge's updates before the next edge's. So that
// the gathers of several edges are in flight at once, a lane first loads its
// slots of the next B edges into registers, then applies them edge by edge.
// KV: slots per lane, ceil(k / 32) rounded up to a power of two.
template <int KV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stream_cbsr_chunk_kernel(const int* __restrict__ indptr,
                         const int* __restrict__ indices,
                         const float* __restrict__ values,
                         const unsigned* __restrict__ pchannels,
                         const float* __restrict__ pre,
                         const float* __restrict__ post,
                         const int* __restrict__ chunk_row0,
                         float4* __restrict__ y, float4* __restrict__ carry,
                         int64_t n_chunks, int64_t n_edges, int chunk, int k,
                         int kp, int dim4) {
  constexpr int B = KV >= 4 ? 2 : 8 / KV;  // edges loaded ahead
  // [warps][dim4] accumulators, then [warps][chunk] ids and [warps][chunk] pre
  extern __shared__ float4 cbsr_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (c >= n_chunks) return;  // c is uniform across the warp
  float4* acc4 = cbsr_smem + warp * dim4;
  float* acc = reinterpret_cast<float*>(acc4);
  int* ids = reinterpret_cast<int*>(cbsr_smem + kWarpsPerBlock * dim4);
  int* s_id = ids + warp * chunk;
  float* s_pre = reinterpret_cast<float*>(ids + kWarpsPerBlock * chunk) +
                 warp * chunk;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  const int64_t lo = c * chunk;
  const int64_t hi = min(lo + chunk, n_edges);
  for (int i = lane; i < hi - lo; i += 32) {
    const int u = indices[lo + i];
    s_id[i] = u;
    s_pre[i] = pre != nullptr ? pre[u] : 1.f;
  }
  for (int q = lane; q < dim4; q += 32) acc4[q] = zero;
  __syncwarp();

  int64_t r = chunk_row0[c];
  int64_t e = lo;
  while (e < hi) {
    const int64_t rs = indptr[r];
    const int64_t re = indptr[r + 1];
    if (rs == re) {  // no edges: the carry pass writes the row
      ++r;
      continue;
    }
    const int64_t end = min(re, hi);
    while (e < end) {
      const int j = (int)(e - lo);
      const int nb = (int)min((int64_t)B, end - e);  // uniform across the warp
      float v[B][KV];
      unsigned ch[B][KV];
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (b < nb) {
          const int64_t u = s_id[j + b];
          const float* vr = values + u * k;
          const unsigned* pr = pchannels + u * kp;
#pragma unroll
          for (int t = 0; t < KV; ++t) {
            const int slot = lane + 32 * t;
            if (slot < k) {
              v[b][t] = __ldg(vr + slot);
              ch[b][t] =
                  (__ldg(pr + (slot >> 2)) >> (8 * (slot & 3))) & 0xFFu;
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < B; ++b) {
        if (b < nb) {
          const float s = s_pre[j + b];
#pragma unroll
          for (int t = 0; t < KV; ++t) {
            if (lane + 32 * t < k)
              acc[ch[b][t]] = fmaf(s, v[b][t], acc[ch[b][t]]);
          }
          __syncwarp();
        }
      }
      e += nb;
    }
    float4* out;
    float p = 1.f;
    if (rs < lo) {
      out = carry + c * dim4;  // the row began in an earlier chunk
    } else {
      out = y + r * dim4;
      if (re <= hi && post != nullptr) p = post[r];  // else: goes on, unscaled
    }
    for (int q = lane; q < dim4; q += 32) {
      const float4 a = acc4[q];
      out[q] = make_float4(a.x * p, a.y * p, a.z * p, a.w * p);
      acc4[q] = zero;
    }
    __syncwarp();
    ++r;
  }
}

template <int NV>
void launch_carry(const int* indptr, const int* carry_rows, const float* post,
                  const float4* carry, float4* y, int64_t n_carry, int chunk,
                  int dim4, cudaStream_t s) {
  if (n_carry > 0) {
    const unsigned blocks =
        (unsigned)((n_carry + kWarpsPerBlock - 1) / kWarpsPerBlock);
    stream_carry_kernel<NV><<<blocks, kWarpsPerBlock * 32, 0, s>>>(
        indptr, carry_rows, post, carry, y, n_carry, chunk, dim4);
  }
}

template <int NV>
void launch(const int* indptr, const int* indices, const float4* x,
            const float* pre, const float* post, const int* chunk_row0,
            const int* carry_rows, float4* y, float4* carry, int64_t n_chunks,
            int64_t n_carry, int64_t n_edges, int chunk, int dim4,
            cudaStream_t s) {
  if (n_chunks > 0) {
    const unsigned blocks =
        (unsigned)((n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const size_t smem = (size_t)kWarpsPerBlock * chunk * 2 * sizeof(int);
    stream_chunk_kernel<NV><<<blocks, kWarpsPerBlock * 32, smem, s>>>(
        indptr, indices, x, pre, post, chunk_row0, y, carry, n_chunks,
        n_edges, chunk, dim4);
  }
  launch_carry<NV>(indptr, carry_rows, post, carry, y, n_carry, chunk, dim4,
                   s);
}

}  // namespace

// y <- post * (A (pre * x)) over the StreamPlan (indptr int32 [n_rows + 1],
// indices int32 [n_edges], chunk_row0 int32 [n_chunks], carry_rows int32
// [n_carry]); x f32 [n_src, dim], y f32 [n_rows, dim], carry f32
// [n_chunks, dim] scratch, pre f32 [n_src] or null, post f32 [n_rows] or
// null. Needs dim % 4 == 0, dim <= 1024, 1 <= chunk <= 512 and 16-byte
// aligned x, y and carry.
extern "C" int stream_spmm(const void* indptr, const void* indices,
                           const void* x, const void* pre, const void* post,
                           const void* chunk_row0, const void* carry_rows,
                           void* y, void* carry, int64_t n_chunks,
                           int64_t n_carry, int64_t n_edges, int chunk,
                           int dim, void* stream) {
  if (dim < 4 || dim % 4 != 0 || dim > 1024 || chunk < 1 || chunk > 512)
    return (int)cudaErrorInvalidValue;
  const int dim4 = dim / 4;
  const int* ip = static_cast<const int*>(indptr);
  const int* ix = static_cast<const int*>(indices);
  const float4* xp = static_cast<const float4*>(x);
  const float* pp = static_cast<const float*>(pre);
  const float* qp = static_cast<const float*>(post);
  const int* c0 = static_cast<const int*>(chunk_row0);
  const int* cr = static_cast<const int*>(carry_rows);
  float4* yp = static_cast<float4*>(y);
  float4* cp = static_cast<float4*>(carry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nv = (dim4 + 31) / 32;
  if (nv <= 1)
    launch<1>(ip, ix, xp, pp, qp, c0, cr, yp, cp, n_chunks, n_carry, n_edges,
              chunk, dim4, s);
  else if (nv <= 2)
    launch<2>(ip, ix, xp, pp, qp, c0, cr, yp, cp, n_chunks, n_carry, n_edges,
              chunk, dim4, s);
  else if (nv <= 4)
    launch<4>(ip, ix, xp, pp, qp, c0, cr, yp, cp, n_chunks, n_carry, n_edges,
              chunk, dim4, s);
  else
    launch<8>(ip, ix, xp, pp, qp, c0, cr, yp, cp, n_chunks, n_carry, n_edges,
              chunk, dim4, s);
  return (int)cudaGetLastError();
}

// y <- post * (A (pre * cbsr(values, channels))) over the StreamPlan, as
// stream_spmm with x given as CBSR: values f32 [n_src, k], pchannels int32
// [n_src, kp] with kp = ceil(k / 4), four uint8 channel ids per word
// (ops/maxk.py::pack_channels), distinct within a row. Needs dim % 4 == 0,
// 4 <= dim <= 256, 1 <= k < dim, 1 <= chunk <= 512 and 16-byte aligned y and
// carry; y equals stream_spmm's on the densified input by value.
extern "C" int stream_cbsr_spmm(const void* indptr, const void* indices,
                                const void* values, const void* pchannels,
                                const void* pre, const void* post,
                                const void* chunk_row0, const void* carry_rows,
                                void* y, void* carry, int64_t n_chunks,
                                int64_t n_carry, int64_t n_edges, int chunk,
                                int k, int kp, int dim, void* stream) {
  if (dim < 4 || dim % 4 != 0 || dim > 256 || k < 1 || k >= dim ||
      kp != (k + 3) / 4 || chunk < 1 || chunk > 512)
    return (int)cudaErrorInvalidValue;
  const int dim4 = dim / 4;
  const int* ip = static_cast<const int*>(indptr);
  const int* cr = static_cast<const int*>(carry_rows);
  const float* qp = static_cast<const float*>(post);
  float4* yp = static_cast<float4*>(y);
  float4* cp = static_cast<float4*>(carry);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_chunks > 0) {
    const unsigned blocks =
        (unsigned)((n_chunks + kWarpsPerBlock - 1) / kWarpsPerBlock);
    const size_t smem =
        (size_t)kWarpsPerBlock * (dim * sizeof(float) + chunk * 2 * sizeof(int));
    const int* ix = static_cast<const int*>(indices);
    const float* vp = static_cast<const float*>(values);
    const unsigned* pc = static_cast<const unsigned*>(pchannels);
    const float* pp = static_cast<const float*>(pre);
    const int* c0 = static_cast<const int*>(chunk_row0);
    const int kv = (k + 31) / 32;
#define CBSR_LAUNCH(KV)                                                   \
  stream_cbsr_chunk_kernel<KV><<<blocks, kWarpsPerBlock * 32, smem, s>>>( \
      ip, ix, vp, pc, pp, qp, c0, yp, cp, n_chunks, n_edges, chunk, k, kp, \
      dim4)
    if (kv <= 1)
      CBSR_LAUNCH(1);
    else if (kv <= 2)
      CBSR_LAUNCH(2);
    else if (kv <= 4)
      CBSR_LAUNCH(4);
    else
      CBSR_LAUNCH(8);
#undef CBSR_LAUNCH
  }
  if (dim4 <= 32)
    launch_carry<1>(ip, cr, qp, cp, yp, n_carry, chunk, dim4, s);
  else
    launch_carry<2>(ip, cr, qp, cp, yp, n_carry, chunk, dim4, s);
  return (int)cudaGetLastError();
}
