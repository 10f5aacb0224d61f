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
// edge: E dim 4 B, about 127 GB or 38 ms when L2 catches no reuse. The
// stand-in's destinations are uniform, so the only reuse L2 can give is of
// the rows gathered most, and an LRU L2 under a 127 GB cold stream keeps
// almost none of them.
//
// Design (the summation order and the plan's row rules are those of the
// first version, so y is the same bits):
// - The hot set. The plan picks the source rows gathered most, by count
//   (graphs/stream_tiles.py::HotSet, a bitmask over source ids sized by a
//   byte budget of L2). A hot row is loaded with an L2 evict_last policy, a
//   cold one with evict_first (createpolicy + ld.global.nc.L2::cache_hint,
//   a hint per load: no device-wide state is left behind), so the cold
//   stream does not push the hot rows out. The indices stream in and y
//   streams out with the evict-first cache-streaming operators.
// - One warp walks a span of `warp_chunks` consecutive chunks, 32 edges at
//   a time.
//   The ids of the next two batches and the pre factors and hot bits of the
//   next one are loaded while the current batch is gathered, so no chunk
//   starts with a round trip for its ids. An id carries its hot bit in its
//   top bit, so that one shuffle hands a lane both.
// - A ring of D source rows in registers, fetched D edges ahead across row
//   ends and chunk ends: the fetch never drains inside the warp's range. A
//   row end writes the row's sum (and reads the next row's bounds from a
//   window of 32 indptr entries held across the warp's lanes) while the
//   next D rows are already in flight.
// - Rows: a row's sum is a running f32 sum in edge order within a chunk,
//   and its chunks' partial sums are added in chunk order. The warp keeps
//   a row's sum over the chunks of its span (the row's first segment, then
//   each later chunk's added), so a row whose edges lie in the span is
//   written whole, times post, by its warp. A row that goes on past the
//   span is written into y unscaled at the span's end; a chunk's first
//   segment, where its row began before the warp's span, goes to the
//   chunk's carry slot. A second kernel takes one warp per carry row
//   (StreamPlan.carry_rows): an empty row comes out 0, a row across spans
//   adds the carry slots of its chunks past its first span to y in chunk
//   order and takes its post factor. Each value has one writer per pass and
//   the sums run in a fixed order: no atomics, and two runs give the same
//   bits, whatever the hot set, the fetch depth or the span.
//
// stream_cbsr_spmm, the second export, replaces the TPU kernel
// spgemm_gnn_tpu/kernels/stream_pallas.py::_stream_cbsr_kernel (through
// stream_spmm_cbsr and kernels/planned.py, behind STREAM_CBSR_FORWARD): the
// same forward product on a k-sparse input given as one CBSR record per
// source node (ops/maxk.py::cbsr_records: k f32 values, then ceil(k/4)
// words of four uint8 channel ids; 160 B at k = 32), so that per edge the
// gather reads one contiguous record instead of a dense row of dim floats
// (1 KB at dim 256). The TPU kernel densified each gathered tile by k
// one-hot steps and reduced it on the MXU; here each warp scatters its
// edges' nonzero values into a dense row accumulator in shared memory, in
// edge order (a load and a store per nonzero slot), and keeps stream_spmm's
// walk, hot set (at the record's size), row rules and carry pass. Bound on
// this card: memory. At ogbn-products (k 32, dim 256) each byte once is
// about 3.4 GB (y alone 2.5 GB), 1.0 ms at 3.35 TB/s; with no reuse of the
// gathered records E * 164 B, about 20 GB or 6 ms, but a record is five
// random 32-byte sectors, which DRAM serves far below its peak. Skipped
// channels hold zeros, and adding a zero product to a sum that started at
// +0 leaves it as it is, so y equals stream_spmm's y on the densified input
// by value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;

__device__ __forceinline__ void fma4(float4& acc, float s, const float4& q) {
  acc.x = fmaf(s, q.x, acc.x);
  acc.y = fmaf(s, q.y, acc.y);
  acc.z = fmaf(s, q.z, acc.z);
  acc.w = fmaf(s, q.w, acc.w);
}

__device__ __forceinline__ float4 scale4(const float4& a, float p) {
  return make_float4(a.x * p, a.y * p, a.z * p, a.w * p);
}

__device__ __forceinline__ float4 add4(const float4& a, const float4& b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// An L2 eviction policy for the loads of one row: evict_last for a hot row,
// evict_first for a cold one.
__device__ __forceinline__ uint64_t l2_policy(bool keep) {
  uint64_t p;
  if (keep)
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  else
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  return p;
}

__device__ __forceinline__ float4 ld_hint(const float4* a, uint64_t pol) {
  float4 v;
  asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(a), "l"(pol));
  return v;
}

__device__ __forceinline__ unsigned ld_hint(const unsigned* a, uint64_t pol) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.b32 %0, [%1], %2;"
      : "=r"(v)
      : "l"(a), "l"(pol));
  return v;
}

__device__ __forceinline__ unsigned ld_hint(const uint8_t* a, uint64_t pol) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.u8 %0, [%1], %2;"
      : "=r"(v)
      : "l"(a), "l"(pol));
  return v;
}

// What a warp's walk over its chunks reads and writes, besides the rows.
// Edges and rows are counted in int: the CSR's indptr is int32.
struct Walk {
  const int* indptr;
  const int* indices;
  const float* pre;       // or null
  const float* post;      // or null
  const int* chunk_row0;
  const unsigned* hot;    // hot-set bitmask over source ids, or null
  float4* y;
  float4* carry;
  int n_chunks, n_edges, n_rows, chunk, warp_chunks, dim4;
};

// stream_spmm's rows: NV float4 slices per lane (lane + 32 t), summed in
// registers.
template <int NV>
struct DenseRows {
  struct Src {
    const float4* x;
  };
  struct Slot {
    float4 v[NV];
  };
  static constexpr int kSmemFloats = 0;  // per warp, in units of dim

  const float4* x;
  int dim4, lane;
  float4 acc[NV];   // the current chunk's segment
  float4 head[NV];  // the row's sum over the span's chunks so far

  __device__ __forceinline__ DenseRows(const Src& s, float4*, int dim4_,
                                       int lane_)
      : x(s.x), dim4(dim4_), lane(lane_) {
#pragma unroll
    for (int t = 0; t < NV; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  __device__ __forceinline__ void load(Slot& sl, int u, uint64_t pol) const {
    const float4* xr = x + (int64_t)u * dim4;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = lane + 32 * t;
      if (col < dim4) sl.v[t] = ld_hint(xr + col, pol);
    }
  }

  __device__ __forceinline__ void consume(const Slot& sl, float s) {
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = lane + 32 * t;
      if (col < dim4) fma4(acc[t], s, sl.v[t]);
    }
  }

  // a segment ends: head = its sum (the row's first) or head + its sum
  __device__ __forceinline__ void take(bool first) {
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      head[t] = first ? acc[t] : add4(head[t], acc[t]);
      acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void write(float4* out, float p) const {
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = lane + 32 * t;
      if (col < dim4) __stcs(out + col, scale4(head[t], p));
    }
  }
};

// stream_cbsr_spmm's rows: a record of k values and kp packed id words per
// source node (row stride rw = k + kp words). Lane j takes slots j, j + 32,
// ... (one 128-byte line of values per edge at k = 32) and their ids, bytes
// j, j + 32, ... of the packed words (one 32-byte sector at k = 32).
// The scatter adds pre[u] * v into the warp's dense row accumulator of dim
// floats in shared memory at that channel. A slot whose value is zero is
// skipped: adding a zero product to a sum that started at +0 leaves it as
// it is (the sum is never -0), so the bits are those of the dense sum, and
// the padded slots of a short row cost no shared-memory traffic. The k
// channels of a record are distinct, so no two lanes touch one address
// within an edge; a __syncwarp orders one edge's updates before the next
// edge's. KV: slots per lane, ceil(k / 32) rounded up to a power of two.
// SCATTER false is the timing variant of utils/stream_sweep.py, never on the
// path: it sums each lane's values in registers with no channel and no
// shared-memory update (a wrong y at the same traffic), so that the
// scatter's cost is measured.
template <int KV, bool SCATTER>
struct CbsrRecords {
  struct Src {
    const unsigned* rec;
    int k, kp;
  };
  struct Slot {
    float v[KV];
    unsigned c[KV];
  };
  static constexpr int kSmemFloats = 1;  // a row accumulator of dim floats

  const unsigned* rec;
  float4* acc4;   // the current chunk's segment, dim floats in shared memory
  float* acc;
  int k, rw, dim4, lane;
  float4 head[2];  // float4s lane and lane + 32 of the row's sum so far
  float reg[KV];   // the variant's sums

  __device__ __forceinline__ CbsrRecords(const Src& s, float4* smem,
                                         int dim4_, int lane_)
      : rec(s.rec), acc4(smem), acc(reinterpret_cast<float*>(smem)),
        k(s.k), rw(s.k + s.kp), dim4(dim4_), lane(lane_) {
#pragma unroll
    for (int t = 0; t < KV; ++t) reg[t] = 0.f;
    for (int q = lane; q < dim4; q += 32)
      acc4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
  }

  __device__ __forceinline__ void load(Slot& sl, int u, uint64_t pol) const {
    const unsigned* rr = rec + (int64_t)u * rw;
    const uint8_t* ids = reinterpret_cast<const uint8_t*>(rr + k);
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      const int j = lane + 32 * t;
      if (j < k) {
        sl.v[t] = __uint_as_float(ld_hint(rr + j, pol));
        sl.c[t] = ld_hint(ids + j, pol);
      }
    }
  }

  __device__ __forceinline__ void consume(const Slot& sl, float s) {
    if (!SCATTER) {
      // the id joins the sum (as a denormal) so that its load stays
#pragma unroll
      for (int t = 0; t < KV; ++t)
        if (lane + 32 * t < k)
          reg[t] = fmaf(s, sl.v[t], reg[t]) + __uint_as_float(sl.c[t]);
      return;
    }
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      if (lane + 32 * t < k && sl.v[t] != 0.f)
        acc[sl.c[t]] = fmaf(s, sl.v[t], acc[sl.c[t]]);
    }
    __syncwarp();
  }

  // a segment ends: head = its sum (the row's first) or head + its sum
  // (dim <= 256: at most 64 float4s, two per lane)
  __device__ __forceinline__ void take(bool first) {
    if (!SCATTER) {
#pragma unroll
      for (int t = 0; t < KV; ++t) {
        const int j = lane + 32 * t;
        if (j < k && j < 4 * dim4) acc[j] = reg[t];
        reg[t] = 0.f;
      }
      __syncwarp();
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int q = lane + 32 * t;
      if (q < dim4) {
        const float4 a = acc4[q];
        head[t] = first ? a : add4(head[t], a);
        acc4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    __syncwarp();
  }

  __device__ __forceinline__ void write(float4* out, float p) const {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int q = lane + 32 * t;
      if (q < dim4) __stcs(out + q, scale4(head[t], p));
    }
  }
};

// One warp per `warp_chunks` consecutive chunks; Op gathers, sums and writes
// the rows. D: source rows fetched ahead into registers (divides 32).
template <class Op, int D>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stream_walk_kernel(const Walk w, const typename Op::Src src) {
  extern __shared__ float4 walk_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c0l =
      ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * w.warp_chunks;
  if (c0l >= w.n_chunks) return;  // c0 is uniform across the warp
  const int c0 = (int)c0l;
  const int lo = c0 * w.chunk;
  const int hi = min(min(c0 + w.warp_chunks, w.n_chunks) * w.chunk,
                     w.n_edges);
  const uint64_t keep = l2_policy(true);
  const uint64_t drop = l2_policy(false);
  Op op(src, walk_smem + warp * Op::kSmemFloats * w.dim4, w.dim4, lane);

  // edge base + lane of the current batch: its id with the hot bit in bit
  // 31 (ids are below 2^31) and its pre factor; the same for base + 32 +
  // lane; the bare id of base + 64 + lane
  auto id_at = [&](int e) -> int {
    return e < hi ? __ldcs(w.indices + e) : 0;
  };
  auto pre_at = [&](int u, int e) -> float {
    return (w.pre != nullptr && e < hi) ? __ldg(w.pre + u) : 1.f;
  };
  auto with_hot = [&](int u, int e) -> int {
    const bool hot = w.hot != nullptr && e < hi &&
                     ((__ldg(w.hot + (u >> 5)) >> (u & 31)) & 1u);
    return hot ? (int)((unsigned)u | 0x80000000u) : u;
  };
  const int u0 = id_at(lo + lane);
  const int u1 = id_at(lo + 32 + lane);
  int nnu = id_at(lo + 64 + lane);
  float cs = pre_at(u0, lo + lane);
  int cu = with_hot(u0, lo + lane);
  float ns = pre_at(u1, lo + 32 + lane);
  int nu = with_hot(u1, lo + 32 + lane);
  // a row's id and policy from its packed id
  auto fetch = [&](typename Op::Slot& sl, int uh) {
    op.load(sl, uh & 0x7fffffff, uh < 0 ? keep : drop);
  };

  // indptr[wb + lane], a window of 32 row bounds across the lanes
  int r = w.chunk_row0[c0];
  int wb = r;
  int ipw = __ldg(w.indptr + min(wb + lane, w.n_rows));
  auto ip = [&](int i) -> int {  // indptr[i], i >= wb, uniform
    if (i - wb >= 32) {
      wb = i;
      ipw = __ldg(w.indptr + min(wb + lane, w.n_rows));
    }
    return __shfl_sync(kFull, ipw, i - wb);
  };
  int rs = ip(r);
  int re = ip(r + 1);
  float pr = w.post != nullptr ? __ldg(w.post + r) : 1.f;
  int q = c0;  // the current chunk, its edges [qlo, qhi)
  int qlo = lo;
  int qhi = min(lo + w.chunk, w.n_edges);
  int seg_end = min(re, qhi);

  typename Op::Slot slot[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int uh = __shfl_sync(kFull, cu, d);
    if (lo + d < hi) fetch(slot[d], uh);
  }

  for (int base = lo; base < hi; base += 32) {
    const int n_in = min(32, hi - base);
    for (int g = 0; g < n_in; g += D) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int i = g + d;  // slot d holds edge base + i
        if (i < n_in) {
          const int e = base + i;
          op.consume(slot[d], w.pre != nullptr
                                  ? __shfl_sync(kFull, cs, i) : 1.f);
          const int j = i + D;  // fetch edge base + j into the freed slot
          const int uh = __shfl_sync(kFull, j < 32 ? cu : nu, j & 31);
          if (e + D < hi) fetch(slot[d], uh);
          if (e + 1 == seg_end) {  // the segment ends
            const bool before = rs < lo;  // the row began before the span
            op.take(before || rs >= qlo);
            float4* out = nullptr;
            float p = 1.f;
            if (before) {
              out = w.carry + (int64_t)q * w.dim4;
            } else if (re <= qhi) {  // the row ends: whole, times post
              out = w.y + (int64_t)r * w.dim4;
              p = pr;
            } else if (qhi == hi) {  // goes on past the span: unscaled
              out = w.y + (int64_t)r * w.dim4;
            }
            if (out != nullptr) op.write(out, p);
            if (e + 1 < hi) {
              if (e + 1 == re) {  // the next row with edges
                rs = re;
                do {
                  ++r;
                  re = ip(r + 1);
                } while (re == rs);
                pr = w.post != nullptr ? __ldg(w.post + r) : 1.f;
              }
              if (e + 1 == qhi) {
                ++q;
                qlo = qhi;
                qhi = min(qlo + w.chunk, w.n_edges);
              }
              seg_end = min(re, qhi);
            }
          }
        }
      }
    }
    cu = nu;
    cs = ns;
    ns = pre_at(nnu, base + 64 + lane);
    nu = with_hot(nnu, base + 64 + lane);
    nnu = id_at(base + 96 + lane);
  }
}

template <int NV>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stream_carry_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ carry_rows,
                    const float* __restrict__ post,
                    const float4* __restrict__ carry, float4* __restrict__ y,
                    int64_t n_carry, int chunk, int warp_chunks, int dim4) {
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
    // the chunks past the row's first span, whose sum y holds
    const int64_t last = (b - 1) / chunk;
#pragma unroll 4
    for (int64_t q = (a / chunk / warp_chunks + 1) * warp_chunks; q <= last;
         ++q) {
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
    if (col < dim4) yr[col] = scale4(acc[t], p);
  }
}

unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <class Op, int D>
void launch_walk(const Walk& w, const typename Op::Src& src, cudaStream_t s) {
  if (w.n_chunks == 0) return;
  const int64_t warps = (w.n_chunks + w.warp_chunks - 1) / w.warp_chunks;
  const size_t smem =
      (size_t)kWarpsPerBlock * Op::kSmemFloats * w.dim4 * sizeof(float4);
  stream_walk_kernel<Op, D>
      <<<blocks_for(warps), kWarpsPerBlock * 32, smem, s>>>(w, src);
}

void launch_carry(int nv, const int* indptr, const int* carry_rows,
                  const float* post, const float4* carry, float4* y,
                  int64_t n_carry, int chunk, int warp_chunks, int dim4,
                  cudaStream_t s) {
  if (n_carry == 0) return;
  const unsigned blocks = blocks_for(n_carry);
  const int threads = kWarpsPerBlock * 32;
  if (nv <= 1)
    stream_carry_kernel<1><<<blocks, threads, 0, s>>>(
        indptr, carry_rows, post, carry, y, n_carry, chunk, warp_chunks,
        dim4);
  else if (nv <= 2)
    stream_carry_kernel<2><<<blocks, threads, 0, s>>>(
        indptr, carry_rows, post, carry, y, n_carry, chunk, warp_chunks,
        dim4);
  else if (nv <= 4)
    stream_carry_kernel<4><<<blocks, threads, 0, s>>>(
        indptr, carry_rows, post, carry, y, n_carry, chunk, warp_chunks,
        dim4);
  else
    stream_carry_kernel<8><<<blocks, threads, 0, s>>>(
        indptr, carry_rows, post, carry, y, n_carry, chunk, warp_chunks,
        dim4);
}

// float4 slices per lane for dim4 float4s: ceil(dim4 / 32) rounded up to a
// power of two
int slices(int n) { return n <= 32 ? 1 : n <= 64 ? 2 : n <= 128 ? 4 : 8; }

Walk make_walk(const void* indptr, const void* indices, const void* pre,
               const void* post, const void* chunk_row0, const void* hot,
               void* y, void* carry, int64_t n_rows, int64_t n_chunks,
               int64_t n_edges, int chunk, int warp_chunks, int dim4) {
  Walk w;
  w.indptr = static_cast<const int*>(indptr);
  w.indices = static_cast<const int*>(indices);
  w.pre = static_cast<const float*>(pre);
  w.post = static_cast<const float*>(post);
  w.chunk_row0 = static_cast<const int*>(chunk_row0);
  w.hot = static_cast<const unsigned*>(hot);
  w.y = static_cast<float4*>(y);
  w.carry = static_cast<float4*>(carry);
  w.n_chunks = (int)n_chunks;
  w.n_edges = (int)n_edges;
  w.n_rows = (int)n_rows;
  w.chunk = chunk;
  w.warp_chunks = warp_chunks;
  w.dim4 = dim4;
  return w;
}

// The walk counts edges and rows in int, and reads ids up to 96 edges past
// a warp's range.
bool fits_int(int64_t n_rows, int64_t n_edges) {
  return n_rows < INT32_MAX && n_edges < (int64_t)INT32_MAX - 1024;
}

}  // namespace

// y <- post * (A (pre * x)) over the StreamPlan (indptr int32 [n_rows + 1],
// indices int32 [n_edges], chunk_row0 int32 [n_chunks], carry_rows int32
// [n_carry]); hot a bitmask int32 [ceil(n_src / 32)] of the hot source rows,
// or null; x f32 [n_src, dim], y f32 [n_rows, dim], carry f32 [n_chunks,
// dim] scratch, pre f32 [n_src] or null, post f32 [n_rows] or null. depth:
// rows fetched ahead into registers, 4, 8 or 16 at dim <= 256, 4 at dim <=
// 512, 2 above; warp_chunks >= 1: chunks per warp span (the plan's, whose
// carry_rows follow it). Needs dim % 4 == 0,
// dim <= 1024, 1 <= chunk <= 512, n_edges < 2^31 - 1024 and 16-byte
// aligned x, y and carry.
extern "C" int stream_spmm(const void* indptr, const void* indices,
                           const void* x, const void* pre, const void* post,
                           const void* chunk_row0, const void* carry_rows,
                           const void* hot, void* y, void* carry,
                           int64_t n_rows, int64_t n_chunks, int64_t n_carry,
                           int64_t n_edges, int chunk, int dim, int depth,
                           int warp_chunks, void* stream) {
  if (dim < 4 || dim % 4 != 0 || dim > 1024 || chunk < 1 || chunk > 512 ||
      warp_chunks < 1 || !fits_int(n_rows, n_edges))
    return (int)cudaErrorInvalidValue;
  const int dim4 = dim / 4;
  const int nv = slices(dim4);
  const Walk w = make_walk(indptr, indices, pre, post, chunk_row0, hot, y,
                           carry, n_rows, n_chunks, n_edges, chunk,
                           warp_chunks, dim4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float4* xp = static_cast<const float4*>(x);
#define DENSE(NV_, D_) launch_walk<DenseRows<NV_>, D_>(w, {xp}, s)
  if (nv == 1 && depth == 4)
    DENSE(1, 4);
  else if (nv == 1 && depth == 8)
    DENSE(1, 8);
  else if (nv == 1 && depth == 16)
    DENSE(1, 16);
  else if (nv == 2 && depth == 4)
    DENSE(2, 4);
  else if (nv == 2 && depth == 8)
    DENSE(2, 8);
  else if (nv == 2 && depth == 16)
    DENSE(2, 16);
  else if (nv == 4 && depth == 4)
    DENSE(4, 4);
  else if (nv == 8 && depth == 2)
    DENSE(8, 2);
  else
    return (int)cudaErrorInvalidValue;
#undef DENSE
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_carry(nv, w.indptr, static_cast<const int*>(carry_rows), w.post,
               w.carry, w.y, n_carry, chunk, warp_chunks, dim4, s);
  return (int)cudaGetLastError();
}

// y <- post * (A (pre * cbsr(records))) over the StreamPlan, as stream_spmm
// with x given as one CBSR record per source node: records int32 [n_src,
// k + kp], k f32 values (their bits) then kp = ceil(k / 4) words of four
// uint8 channel ids (ops/maxk.py::cbsr_records), distinct within a row; hot
// as in stream_spmm, for the record's size. batch: edges loaded ahead into
// registers, 4, 8 or 16 at k <= 32, 8 at k <= 64, 4 above; warp_chunks as
// in stream_spmm; scatter 0 is the sweep's timing variant (see
// CbsrRecords), 1 the product. Needs dim % 4 == 0, 4 <= dim <= 256, 1 <= k <
// dim, 1 <= chunk <= 512, n_edges < 2^31 - 1024 and 16-byte aligned y and
// carry; y equals stream_spmm's on the densified input by value.
extern "C" int stream_cbsr_spmm(const void* indptr, const void* indices,
                                const void* records, const void* pre,
                                const void* post, const void* chunk_row0,
                                const void* carry_rows, const void* hot,
                                void* y, void* carry, int64_t n_rows,
                                int64_t n_chunks, int64_t n_carry,
                                int64_t n_edges, int chunk, int k, int kp,
                                int dim, int batch, int warp_chunks,
                                int scatter, void* stream) {
  if (dim < 4 || dim % 4 != 0 || dim > 256 || k < 1 || k >= dim ||
      kp != (k + 3) / 4 || chunk < 1 || chunk > 512 || warp_chunks < 1 ||
      !fits_int(n_rows, n_edges))
    return (int)cudaErrorInvalidValue;
  const int dim4 = dim / 4;
  const Walk w = make_walk(indptr, indices, pre, post, chunk_row0, hot, y,
                           carry, n_rows, n_chunks, n_edges, chunk,
                           warp_chunks, dim4);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned* rp = static_cast<const unsigned*>(records);
  const int kv = slices(k);
#define CBSR(KV_, B_, S_) launch_walk<CbsrRecords<KV_, S_>, B_>(w, {rp, k, kp}, s)
  if (kv == 1 && batch == 4 && scatter)
    CBSR(1, 4, true);
  else if (kv == 1 && batch == 8 && scatter)
    CBSR(1, 8, true);
  else if (kv == 1 && batch == 16 && scatter)
    CBSR(1, 16, true);
  else if (kv == 1 && batch == 4)
    CBSR(1, 4, false);
  else if (kv == 1 && batch == 8)
    CBSR(1, 8, false);
  else if (kv == 1 && batch == 16)
    CBSR(1, 16, false);
  else if (kv == 2 && batch == 8 && scatter)
    CBSR(2, 8, true);
  else if (kv == 4 && batch == 4 && scatter)
    CBSR(4, 4, true);
  else if (kv == 8 && batch == 4 && scatter)
    CBSR(8, 4, true);
  else
    return (int)cudaErrorInvalidValue;
#undef CBSR
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_carry(dim4 <= 32 ? 1 : 2, w.indptr,
               static_cast<const int*>(carry_rows), w.post, w.carry, w.y,
               n_carry, chunk, warp_chunks, dim4, s);
  return (int)cudaGetLastError();
}
