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
//
// The bf16 forms (the 16-bit feature stream, "bf16x2"): stream_spmm_bf16
// replaces the TPU kernel's bf16 stream (stream_pallas.py::stream_spmm,
// messages cast at :227-228) and stream_cbsr_spmm_bf16 its bf16 values
// (stream_spmm_cbsr, :158-159). The rows or the record values are bf16,
// already rounded from pre * x by round_rows (csrc/round.cu), so the planner
// passes no pre; each is widened exactly to f32 in registers, and the sums,
// carry slots, y and post stay f32. The walk's rules, the carry pass, the
// hot set (at the 16-bit row or record size) and the L2 hints are the f32
// kernels'. A dense row is 512 B at dim 256 (a lane loads 16 B, 8
// channels), so the no-reuse gather falls to E * 512 B, about 63 GB or 19 ms
// at ogbn-products, and the same L2 budget holds twice the hot rows.
// stream_cbsr_spmm_bf16 runs its own kernel, stream_cbsr16_kernel, on a
// record of one 32-bit word a slot (bf16 value high, channel low; 128 B at
// k <= 32): the f32 walk's one warp step an edge, with two shuffles to
// unpack a packed record and a per-edge fetch, issued about 60 instructions
// an edge and was held by that, not by memory (ogbn-products, k 32: 10.8
// ms, 7.7 of it with no record loaded; utils/stream_sweep.py, PERF.md).
// Its records come by cp.async, four to a warp copy, into a ring in shared
// memory, and an edge is a shared-memory load and the scatter.
//
// stream_spmm_bf16_out and stream_cbsr_spmm_bf16_out are the bf16 forms with
// a bf16 output: the 16-bit model (--dtype bfloat16), whose aggregation keeps
// 16 bits (stream_pallas.py:217-242 `out_dtype`, then the post factor in bf16
// at spgemm_gnn_tpu/kernels/planned.py:323). The rows or record values are
// already bf16(pre * x) in the caller's bf16 arithmetic, so they take no pre.
// The sums are the f32-output kernels', in the same order, and y rounds once,
// where the row's final value is known, as bf16(bf16(sum) * bf16(post)) (two
// roundings, the reference's; the product of two bf16 values is exact in
// f32). Partial sums never pass through the bf16 y: a row that goes on past
// its warp's span leaves its first span's sum in an f32 slot of that span
// (`heads`, one row of dim floats per span; at most one row per span goes on
// past it), and the carry pass reads it from there. The TPU kernel instead
// rounds its bf16 carry at each group boundary (stream_pallas.py:242, :192);
// rounding once is the more exact of the two.
//
// stream_sspmm_bf16 (and its bf16 output, out16) replaces the TPU kernels'
// composition in spgemm_gnn_tpu/kernels/planned.py:233 sspmm_backward: B3
// on Aᵀ (stream_pallas.py:37, bf16 stream :227-228, out_dtype :217-242),
// then B4's channel sampling (spgemm_pallas.py:385). It is MaxK's backward
// on a stream plan: the cotangent of an aggregation whose input is MaxK's
// output is needed only at the k channels ch[v, .] each row kept, so it
// computes dx[v, ch[v, j]] = post[v] * sum_u m[u, ch[v, j]] and writes 0 at
// the row's other channels (the dense row, which MaxK's backward reads).
// The dense bf16 form gathers a 512-B row an edge for the 64 B that survive
// (dim 256, k 32): at 94 % of that no-reuse gather it had nothing left to
// win, and gathering only the k channels of each row touches about 14 of a
// row's 16 sectors. So it runs in two passes, the source paper's SSpMM
// turned into an outer product (ch and the edge order decide where each
// term goes): pass 1 (sspmm_slots_kernel) walks A's CSR once, reads each
// message row m[u] once and writes edge u <- v's k terms m[u, ch[v, .]] to
// a 2k-byte slot at that edge's position in Aᵀ's edge order (the plan's
// transpose positions); pass 2 (sspmm_walk_kernel) walks Aᵀ's spans as B3
// does and reads each edge's slot in order. The sum of each kept channel
// takes B3's order (a running sum a chunk segment, the segments added in
// chunk order, the carry pass), so it is stream_spmm_bf16's bit for bit.
// Bound on this card at ogbn-products: bytes, about 4.3 GB (m, the ids,
// Aᵀ's indices and the f32 output once), 1.3 ms; the slots add E 2k bytes
// written at random and read in order (7.9 GB each way at k 32), and pass
// 1's random writes and id reads are what hold it (PERF.md).
//
// stream_sspmm on f32 messages (counted as stream_sspmm) is the same pair
// for the f32 path: the raw f32 cotangent g with the pre factor applied per
// edge, as B3-f32 on Aᵀ applies it (DenseRows::consume forms fmaf(pre[u],
// g[u, c], acc)). So pass 1 writes the raw terms g[u, ch[v, .]], 4k bytes a
// slot (one 128-byte line at k 32), and never pre · g: a product rounded in
// pass 1 and then added is not the bits of the FMA. Pass 2 takes each
// edge's factor pre[u] from Aᵀ's indices, read in order, a batch of 32
// edges' ids two batches ahead and their factors one batch ahead, as B3's
// walk loads them (pre is 9.8 MB at ogbn-products, and stays in L2); each
// term is then fmaf(pre[u], term, acc), so each sum is stream_spmm's at
// that channel bit for bit. Both passes are the bf16 form's kernels, as
// templates over the term type; a pass-2 tile holds at most 2 KB of slots
// in either (16 edges at k <= 32 in f32, 32 in bf16), so a block's shared
// memory stays under 48 KB at every k. (Storing pre[u] beside the terms
// instead, 4 (k + 1) bytes rounded up to 16 a slot, gave the same bits and
// lost: 43.98 ms against 24.57 at ogbn-products, PERF.md.) Bound at
// ogbn-products (k 32): bytes, about 5.6 GB (g and the output 2.5 GB each,
// the ids, Aᵀ's indices and pre once), 1.67 ms; the slots add E 4k bytes
// each way, 15.8 GB or 4.7 ms at 3.35 TB/s.

#include <cuda_bf16.h>
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

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// a sampled backward's term as f32: a bf16 value (its bits) widened
// exactly, or an f32 value
__device__ __forceinline__ float term(uint16_t v) {
  return __uint_as_float((unsigned)v << 16);
}
__device__ __forceinline__ float term(float v) { return v; }

__device__ __forceinline__ unsigned pack2(float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const unsigned*>(&h);
}

// four f32 sums as bf16(bf16(v) * p), p a bf16 value: the bf16 outputs
__device__ __forceinline__ uint2 round_out(const float4& v, float p) {
  return make_uint2(pack2(bf16_round(v.x) * p, bf16_round(v.y) * p),
                    pack2(bf16_round(v.z) * p, bf16_round(v.w) * p));
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

__device__ __forceinline__ uint4 ld_hint(const uint4* a, uint64_t pol) {
  uint4 v;
  asm("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
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

__device__ __forceinline__ unsigned ld_hint(const uint16_t* a, uint64_t pol) {
  unsigned v;
  asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
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
  uint2* y16;     // the bf16 output (the _out forms), or null
  float4* heads;  // per span, the sum of the row that goes on past it (_out)
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
  static constexpr bool kSampled = false;  // writes whole rows of dim
  static constexpr bool kIds = true;       // reads the edges' source ids
  static __host__ __device__ int smem4(const Src&, int dim4) {
    return kSmemFloats * dim4;
  }

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

  __device__ __forceinline__ void load(Slot& sl, int u, int,
                                      uint64_t pol) const {
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

// stream_spmm_bf16's rows: NV uint4 slices per lane (lane + 32 t), 8 bf16
// channels each (channel 2i in the low half of word i), widened exactly to
// two float4 sums in registers: float4s 2 (lane + 32 t) and 2 (lane + 32 t)
// + 1 of the f32 row.
template <int NV>
struct Bf16Rows {
  struct Src {
    const uint4* x;
  };
  struct Slot {
    uint4 v[NV];
  };
  static constexpr int kSmemFloats = 0;
  static constexpr bool kSampled = false;
  static constexpr bool kIds = true;
  static __host__ __device__ int smem4(const Src&, int dim4) {
    return kSmemFloats * dim4;
  }

  const uint4* x;
  int dim8, lane;
  float4 acc[2 * NV];   // the current chunk's segment
  float4 head[2 * NV];  // the row's sum over the span's chunks so far

  __device__ __forceinline__ Bf16Rows(const Src& s, float4*, int dim4,
                                      int lane_)
      : x(s.x), dim8(dim4 / 2), lane(lane_) {
#pragma unroll
    for (int t = 0; t < 2 * NV; ++t) acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  __device__ __forceinline__ void load(Slot& sl, int u, int,
                                      uint64_t pol) const {
    const uint4* xr = x + (int64_t)u * dim8;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = lane + 32 * t;
      if (col < dim8) sl.v[t] = ld_hint(xr + col, pol);
    }
  }

  __device__ __forceinline__ void consume(const Slot& sl, float s) {
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = lane + 32 * t;
      if (col < dim8) {
        const uint4 q = sl.v[t];
        fma4(acc[2 * t], s,
             make_float4(__uint_as_float(q.x << 16),
                         __uint_as_float(q.x & 0xffff0000u),
                         __uint_as_float(q.y << 16),
                         __uint_as_float(q.y & 0xffff0000u)));
        fma4(acc[2 * t + 1], s,
             make_float4(__uint_as_float(q.z << 16),
                         __uint_as_float(q.z & 0xffff0000u),
                         __uint_as_float(q.w << 16),
                         __uint_as_float(q.w & 0xffff0000u)));
      }
    }
  }

  // a segment ends: head = its sum (the row's first) or head + its sum
  __device__ __forceinline__ void take(bool first) {
#pragma unroll
    for (int t = 0; t < 2 * NV; ++t) {
      head[t] = first ? acc[t] : add4(head[t], acc[t]);
      acc[t] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }

  __device__ __forceinline__ void write(float4* out, float p) const {
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = lane + 32 * t;
      if (col < dim8) {
        __stcs(out + 2 * col, scale4(head[2 * t], p));
        __stcs(out + 2 * col + 1, scale4(head[2 * t + 1], p));
      }
    }
  }

  // the row's bf16 output: 8 channels (16 B) a slice
  __device__ __forceinline__ void write16(uint2* out, float p) const {
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = lane + 32 * t;
      if (col < dim8) {
        const uint2 a = round_out(head[2 * t], p);
        const uint2 b = round_out(head[2 * t + 1], p);
        __stcs(reinterpret_cast<uint4*>(out) + col,
               make_uint4(a.x, a.y, b.x, b.y));
      }
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
  static constexpr bool kSampled = false;
  static constexpr bool kIds = true;
  static __host__ __device__ int smem4(const Src&, int dim4) {
    return kSmemFloats * dim4;
  }

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

  __device__ __forceinline__ void load(Slot& sl, int u, int,
                                      uint64_t pol) const {
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

  __device__ __forceinline__ void write16(uint2* out, float p) const {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int q = lane + 32 * t;
      if (q < dim4) __stcs(out + q, round_out(head[t], p));
    }
  }
};

// stream_sspmm's rows: a row v of Aᵀ sums only its k channels ch[v, .],
// lane j channel ch[v, j] (then j + 32, ...), each term (T: a bf16 value,
// widened exactly, or an f32 value) added as B3's rows add it (an fma by
// the edge's factor, 1 for bf16 terms or pre[u] for f32 ones, in edge
// order; a segment's sum joins the row's by one add), so each sum is bit
// for bit the one B3 forms at that channel. Pass 2 (sspmm_walk_kernel)
// adds edge e's k terms from its slot at e k of `slots`, which pass 1
// filled. On stream_walk_kernel (the k-channel gather probe, bf16 only)
// `load` gathers them, m[u, ch[row(e), j]] for the edge's source u and row
// (edge_row), from the messages. Partial sums (carry slots, span heads)
// are compact rows of k floats padded to a float4 (w.dim4 = ceil(k / 4));
// a finished row goes to the dense output (w.y f32 or w.y16 bf16, dim
// channels) through the warp's staging row in shared memory: zeros, then
// the k sums at their channels.
template <int KV, class T = uint16_t>
struct SampledRows {
  struct Src {
    const T* slots;         // pass 2: [n_edges, k], edge e's terms at e k
    const uint16_t* m;      // the probe: the messages, bf16 [n_src, dim]
    const int* edge_row;    // the probe: each edge's row [n_edges]
    const uint8_t* ch;      // the rows' channels [n_rows, k]
    int k, dim;
  };
  struct Slot {
    unsigned v[KV];
  };
  static constexpr bool kSampled = true;
  static constexpr bool kIds = true;
  static __host__ __device__ int smem4(const Src& s, int) { return s.dim / 4; }

  Src s;
  float4* row4;  // the warp's staging row of dim floats
  int lane;
  float acc[KV];   // the current chunk's segment
  float head[KV];  // the row's sum over the span's chunks so far

  __device__ __forceinline__ SampledRows(const Src& s_, float4* smem, int,
                                         int lane_)
      : s(s_), row4(smem), lane(lane_) {
#pragma unroll
    for (int t = 0; t < KV; ++t) acc[t] = 0.f;
  }

  __device__ __forceinline__ void load(Slot& sl, int u, int e,
                                      uint64_t pol) const {
    const int64_t row = __ldg(s.edge_row + e);
    const uint16_t* mr = s.m + (int64_t)u * s.dim;
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      const int j = lane + 32 * t;
      if (j < s.k) sl.v[t] = ld_hint(mr + __ldg(s.ch + row * s.k + j), pol);
    }
  }

  __device__ __forceinline__ void consume(const Slot& sl, float f) {
#pragma unroll
    for (int t = 0; t < KV; ++t)
      if (lane + 32 * t < s.k)
        acc[t] = fmaf(f, __uint_as_float(sl.v[t] << 16), acc[t]);
  }

  // a segment ends: head = its sum (the row's first) or head + its sum
  __device__ __forceinline__ void take(bool first) {
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      head[t] = first ? acc[t] : head[t] + acc[t];
      acc[t] = 0.f;
    }
  }

  // a partial row: the k sums times p, compact (zeros to the float4 width)
  __device__ __forceinline__ void write(float4* out, float p) const {
    float* o = reinterpret_cast<float*>(out);
    const int kw = (s.k + 3) & ~3;
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      const int j = lane + 32 * t;
      if (j < kw) __stcs(o + j, head[t] * p);
    }
  }

  // a whole row r: f32 head * p, or (OUT16) bf16(bf16(head) * p), at the
  // row's channels of the dense output, zeros elsewhere
  template <bool OUT16>
  __device__ __forceinline__ void finish(const Walk& w, int r, float p) {
    const int dim4 = s.dim / 4;
    for (int q = lane; q < dim4; q += 32)
      row4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
    __syncwarp();
    float* row = reinterpret_cast<float*>(row4);
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      const int j = lane + 32 * t;
      if (j < s.k)
        row[__ldg(s.ch + (int64_t)r * s.k + j)] =
            OUT16 ? head[t] : head[t] * p;
    }
    __syncwarp();
    for (int q = lane; q < dim4; q += 32) {
      if constexpr (OUT16)
        __stcs(w.y16 + (int64_t)r * dim4 + q, round_out(row4[q], p));
      else
        __stcs(w.y + (int64_t)r * dim4 + q, row4[q]);
    }
    __syncwarp();
  }
};

// A warp's rows over its span of chunks, edges [lo, hi): the rows' bounds
// from a window of 32 indptr entries across the lanes, the current row r
// (edges [rs, re), post factor pr), the current chunk q (edges [qlo,
// qhi)) and the next segment end. `end_segment` applies the row rules
// where a segment ends (module comment): both walks below share them.
struct SpanRows {
  const Walk& w;
  int c0, lo, hi, lane;
  int wb, ipw;  // indptr[wb + lane]
  int r, rs, re, q, qlo, qhi, seg_end;
  float pr;

  __device__ __forceinline__ SpanRows(const Walk& w_, int c0_, int lo_,
                                      int hi_, int lane_)
      : w(w_), c0(c0_), lo(lo_), hi(hi_), lane(lane_) {
    r = w.chunk_row0[c0];
    wb = r;
    ipw = __ldg(w.indptr + min(wb + lane, w.n_rows));
    rs = ip(r);
    re = ip(r + 1);
    pr = w.post != nullptr ? __ldg(w.post + r) : 1.f;
    q = c0;
    qlo = lo;
    qhi = min(lo + w.chunk, w.n_edges);
    seg_end = min(re, qhi);
  }

  __device__ __forceinline__ int ip(int i) {  // indptr[i], i >= wb, uniform
    if (i - wb >= 32) {
      wb = i;
      ipw = __ldg(w.indptr + min(wb + lane, w.n_rows));
    }
    return __shfl_sync(kFull, ipw, i - wb);
  }

  // edge e ends the segment: op's segment sum joins the row's, and the
  // row or its part goes where the rules send it; then the next segment.
  // OUT16: finished rows go to the bf16 w.y16, a row that goes on past the
  // span to the span's f32 slot of w.heads.
  template <bool OUT16, class Op>
  __device__ __forceinline__ void end_segment(Op& op, int e) {
    const bool before = rs < lo;  // the row began before the span
    op.take(before || rs >= qlo);
    if constexpr (Op::kSampled) {  // partial rows compact, whole rows dense
      if (before)
        op.write(w.carry + (int64_t)q * w.dim4, 1.f);
      else if (re <= qhi)
        op.template finish<OUT16>(w, r, OUT16 ? bf16_round(pr) : pr);
      else if (qhi == hi)
        op.write(w.heads + (int64_t)(c0 / w.warp_chunks) * w.dim4, 1.f);
    } else if constexpr (OUT16) {
      if (before)
        op.write(w.carry + (int64_t)q * w.dim4, 1.f);
      else if (re <= qhi)  // the row ends: whole, rounded
        op.write16(w.y16 + (int64_t)r * w.dim4, bf16_round(pr));
      else if (qhi == hi)  // goes on past the span: its span's slot
        op.write(w.heads + (int64_t)(c0 / w.warp_chunks) * w.dim4, 1.f);
    } else {
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
    }
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
};

// One warp per `warp_chunks` consecutive chunks; Op gathers, sums and writes
// the rows. D: source rows fetched ahead into registers (divides 32). OUT16:
// finished rows go to the bf16 w.y16, a row that goes on past the span to
// the span's f32 slot of w.heads.
template <class Op, int D, bool OUT16>
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
  Op op(src, walk_smem + warp * Op::smem4(src, w.dim4), w.dim4, lane);

  // edge base + lane of the current batch: its id with the hot bit in bit
  // 31 (ids are below 2^31) and its pre factor; the same for base + 32 +
  // lane; the bare id of base + 64 + lane (an Op that reads no source id
  // loads none)
  auto id_at = [&](int e) -> int {
    return (Op::kIds && e < hi) ? __ldcs(w.indices + e) : 0;
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
  // edge e's row from its packed id: the id and the policy
  auto fetch = [&](typename Op::Slot& sl, int uh, int e) {
    op.load(sl, uh & 0x7fffffff, e, uh < 0 ? keep : drop);
  };

  SpanRows rows(w, c0, lo, hi, lane);

  typename Op::Slot slot[D];
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const int uh = __shfl_sync(kFull, cu, d);
    if (lo + d < hi) fetch(slot[d], uh, lo + d);
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
          if (e + D < hi) fetch(slot[d], uh, e + D);
          if (e + 1 == rows.seg_end) rows.end_segment<OUT16>(op, e);
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

// OUT16: a row's first-span sum is in heads (not y), and the row goes to
// the bf16 y16. SAMPLED (stream_sspmm_bf16): the sums are compact rows of
// the row's k channels ch[r, .] (dim4 float4s), the first-span sum is in
// heads, and the row goes to the dense y or y16 (dim4d float4s a row):
// zeros, then each sum at its channel.
template <int NV, bool OUT16, bool SAMPLED = false>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stream_carry_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ carry_rows,
                    const float* __restrict__ post,
                    const float4* __restrict__ carry, float4* __restrict__ y,
                    const float4* __restrict__ heads,
                    uint2* __restrict__ y16, int64_t n_carry, int chunk,
                    int warp_chunks, int dim4, const uint8_t* __restrict__ ch,
                    int k, int dim4d) {
  const int lane = threadIdx.x & 31;
  const int64_t i =
      (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_carry) return;  // i is uniform across the warp
  const int64_t r = carry_rows[i];
  const int64_t a = indptr[r];
  const int64_t b = indptr[r + 1];
  float4* yr = y + r * dim4;
  // the sum of the row's first span
  const float4* hr =
      (OUT16 || SAMPLED) ? heads + (a / chunk / warp_chunks) * dim4 : yr;
  float4 acc[NV];
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int col = lane + 32 * t;
    acc[t] = (a < b && col < dim4) ? hr[col] : make_float4(0.f, 0.f, 0.f, 0.f);
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
  if constexpr (SAMPLED) {
    const float p = (a < b && post != nullptr)
                        ? (OUT16 ? bf16_round(post[r]) : post[r]) : 1.f;
    float* yf = reinterpret_cast<float*>(y + r * dim4d);
    uint16_t* yh = reinterpret_cast<uint16_t*>(y16 + r * dim4d);
    for (int q = lane; q < dim4d; q += 32) {
      if constexpr (OUT16)
        y16[r * dim4d + q] = make_uint2(0u, 0u);
      else
        y[r * dim4d + q] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    __syncwarp();  // orders the zeros before the sums in the same row
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = lane + 32 * t;
      const float v[4] = {acc[t].x, acc[t].y, acc[t].z, acc[t].w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int j = 4 * col + i;
        if (col < dim4 && j < k) {
          const int c = ch[r * k + j];
          if constexpr (OUT16)
            yh[c] = __bfloat16_as_ushort(
                __float2bfloat16_rn(bf16_round(v[i]) * p));
          else
            yf[c] = v[i] * p;
        }
      }
    }
    return;
  }
  if constexpr (OUT16) {
    const float p = (a < b && post != nullptr) ? bf16_round(post[r]) : 1.f;
#pragma unroll
    for (int t = 0; t < NV; ++t) {
      const int col = lane + 32 * t;
      if (col < dim4) y16[r * dim4 + col] = round_out(acc[t], p);
    }
    return;
  }
  const float p = (a < b && post != nullptr) ? post[r] : 1.f;
#pragma unroll
  for (int t = 0; t < NV; ++t) {
    const int col = lane + 32 * t;
    if (col < dim4) yr[col] = scale4(acc[t], p);
  }
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously, with the L2
// policy keep (hot != 0) or drop (cp.async.cg: not kept in L1).
__device__ __forceinline__ void cp16(unsigned dst, const void* src,
                                     unsigned hot, uint64_t keep,
                                     uint64_t drop) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n"
      " @p cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %3;\n"
      " @!p cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %4;\n}"
      :
      : "r"(dst), "l"(src), "r"(hot), "l"(keep), "l"(drop)
      : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// stream_cbsr_spmm_bf16 and _out: the walk of stream_walk_kernel (the same
// spans, row rules, summation order, carry slots and heads) over records of
// one 32-bit word a slot, the value's bf16 bits in the high half and its
// channel in the low (ops/maxk.py::cbsr_records on bf16 values), 32 KV
// words a node (KV 128-byte lines; slots past k hold 0).
//
// A warp's records come in stages of EPS edges (4 at k <= 32, one 512-byte
// warp copy: 8 lanes a record, 16 bytes a lane; one record of KV lines from
// KV 4 on), copied by cp.async into a ring of S stages of the warp's shared
// memory, S stages ahead (S EPS <= 32 edges in flight): no registers hold
// the records in flight, and the record's address and L2 policy cost a lane
// one shuffle and one copy a stage, not a warp step an edge. An edge then
// takes a warp step of a shared-memory load and the scatter (lane j takes
// slot j: its value widens to f32 by a mask, its channel is the low half),
// and a stage with no segment end runs its EPS edges with no test between
// them. Segment ends (the row rules, the writes and the next row's bounds)
// run at one place, outside the stage's fast path. The scatter, the sums
// and what is written are CbsrRecords<1, true>'s (rows of dim <= 256): y
// equals stream_spmm_bf16's, and the bf16 output stream_spmm_bf16_out's,
// bit for bit on the densified rows.
//
// MODE 0 is the product. MODE 1 and 2 are utils/stream_sweep.py's timing
// variants, never on the path, each with a wrong y by design (as
// CbsrRecords<..., false>): 1 copies the first S stages and no more (the
// warp goes on scattering those records: the walk and the scatter without
// the gather); 2 copies every stage and scatters nothing (a lane folds its
// slot words into a register, stored at the segment's end: the walk and the
// gather).
template <int KV, int S, bool OUT16, int MODE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stream_cbsr16_kernel(const Walk w, const unsigned* __restrict__ rec) {
  constexpr int EPS = KV >= 4 ? 1 : 4 / KV;  // edges a stage
  constexpr int NL = KV > 4 ? KV / 4 : 1;    // 16-byte copies a lane a stage
  constexpr int RW = 32 * KV;                // words a record
  constexpr int SW = RW * EPS;               // words a stage
  static_assert(S * EPS <= 32 && (S & (S - 1)) == 0, "S stages ahead");
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
  float4* acc4 = walk_smem + warp * (w.dim4 + S * SW / 4);
  unsigned* ring = reinterpret_cast<unsigned*>(acc4 + w.dim4);
  CbsrRecords<1, true> op(typename CbsrRecords<1, true>::Src{nullptr, 1, 1},
                          acc4, w.dim4, lane);
  unsigned fold = 0u;  // MODE 2's words

  // edge base + lane of the current batch: its id with the hot bit in bit
  // 31; the same for base + 32 + lane; the bare id of base + 64 + lane
  auto id_at = [&](int e) -> int {
    return e < hi ? __ldcs(w.indices + e) : 0;
  };
  auto with_hot = [&](int u, int e) -> int {
    const bool hot = w.hot != nullptr && e < hi &&
                     ((__ldg(w.hot + (u >> 5)) >> (u & 31)) & 1u);
    return hot ? (int)((unsigned)u | 0x80000000u) : u;
  };
  int cu = with_hot(id_at(lo + lane), lo + lane);
  int nu = with_hot(id_at(lo + 32 + lane), lo + 32 + lane);
  int nnu = id_at(lo + 64 + lane);

  // stage s (edges lo + EPS s ...) into ring slot s % S; `ids` holds the
  // batch of its edges, its first edge at index i0 there
  auto fetch = [&](int s, int ids, int i0) {
    unsigned* slot = ring + (s % S) * SW;
#pragma unroll
    for (int c = 0; c < NL; ++c) {
      const int wq = lane + 32 * c;  // the stage's 16-byte word
      const int ri = wq / (8 * KV);  // of its record ri
      const int uh = __shfl_sync(kFull, ids, (i0 + ri) & 31);
      if (lo + EPS * s + ri < hi)
        cp16(smem_addr(slot + 4 * wq),
             rec + (int64_t)(uh & 0x7fffffff) * RW + 4 * (wq % (8 * KV)),
             (unsigned)uh >> 31, keep, drop);
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < S; ++s) fetch(s, cu, EPS * s);

  SpanRows rows(w, c0, lo, hi, lane);

  // one edge's record: lane j scatters slot j (then j + 32, ...)
  auto consume = [&](const unsigned* sr) {
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      const unsigned wd = sr[lane + 32 * t];
      if constexpr (MODE == 2) {
        fold ^= wd;
      } else {
        const float v = __uint_as_float(wd & 0xffff0000u);
        if (v != 0.f) op.acc[wd & 0xffffu] += v;
      }
    }
    if constexpr (MODE != 2) __syncwarp();
  };
  // edge e ends a segment (MODE 2: its folded words stand in for the sum)
  auto segment_end = [&](int e) {
    if constexpr (MODE == 2) {
      if (lane < 4 * w.dim4)
        op.acc[lane] = __uint_as_float(fold & 0x3fffffffu);
      fold = 0u;
      __syncwarp();
    }
    rows.end_segment<OUT16>(op, e);
  };

  int s = 0;  // the stage at hand: edges lo + EPS s ...
  for (int base = lo; base < hi; base += 32) {
    for (int i0 = 0; i0 < 32 && base + i0 < hi; i0 += EPS, ++s) {
      const int e0 = base + i0;
      if constexpr (MODE == 1)
        cp_wait<0>();
      else
        cp_wait<S - 1>();  // stage s has landed (one group a stage)
      __syncwarp();
      const unsigned* sr = ring + (s % S) * SW;
      if (rows.seg_end > e0 + EPS && e0 + EPS <= hi) {  // no segment end
#pragma unroll
        for (int i = 0; i < EPS; ++i) consume(sr + i * RW);
      } else {
        const int n = min(EPS, hi - e0);
        for (int i = 0; i < n; ++i) {
          consume(sr + i * RW);
          if (e0 + i + 1 == rows.seg_end) segment_end(e0 + i);
        }
      }
      __syncwarp();  // every lane is done with the slot
      if constexpr (MODE != 1) {
        const int ahead = i0 + EPS * S;
        fetch(s + S, ahead < 32 ? cu : nu, ahead & 31);
      }
    }
    cu = nu;
    nu = with_hot(nnu, base + 64 + lane);
    nnu = id_at(base + 96 + lane);
  }
}

// stream_sspmm's pass 1: for each edge u <- v of A (row u of A's CSR,
// source v), the k terms m[u, ch[v, j]] into the slot of the same edge's
// position in Aᵀ's edge order, perm[e], k terms of T a slot (2k bytes for
// bf16 messages, 4k for f32 ones). A warp walks a span of
// warp_chunks chunks of A's plan (so a long row is split across warps, as
// the walk splits it), with the rows' bounds from a window of 32 indptr
// entries across its lanes. It keeps the row m[u] in its shared memory and
// the next row's in registers, loaded a row ahead (NR 16-byte words a lane:
// 1 for a bf16 row, 2 for an f32 row of dim <= 256). Lane j takes slot j
// (then j + 32, ...): a slot is one contiguous warp store, evict-first. No
// sum is formed here; f32 terms are g's own values, the factor is pass 2's.
//
// The id rows ch[v, .] are this pass's random reads, and the first version
// (a byte a lane, a warp load an edge) waited on them: with no id loaded
// it took half its time (utils/stream_sweep.py's variants, PERF.md). So
// where k % 4 == 0 and k <= 128 (WORDS), a lane loads an id row's 4-byte
// word, L lanes a row (L = k / 4 rounded up to a power of two), 32 / L rows
// a warp load: a batch of 32 edges' ids is L registers a lane, and the next
// batch's are loaded while this batch's slots are written (ping-pong); an
// edge's id for lane j is then a shuffle of the word and a byte select.
// Other k take the ids a byte a lane, EB = 32 / KV edges a group (BYTES).
// Both load the ids with an L2 evict-last hint.
//
// MODE 0 is the product; 1-3 are timing variants of utils/stream_sweep.py
// with wrong slots by design: 1 stores nothing (the ids and rows folded
// into one word a lane), 2 stores each slot at its own edge e (in order,
// not at perm[e]), 3 loads no id (lane j reads channel j).
template <class T, int KV, int L, int MODE>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 4)
sspmm_slots_kernel(const int* __restrict__ indptr,
                   const int* __restrict__ indices,
                   const int* __restrict__ chunk_row0,
                   const int* __restrict__ perm, const uint4* __restrict__ m,
                   const uint8_t* __restrict__ ch,
                   T* __restrict__ slots, int n_rows, int n_chunks,
                   int n_edges, int chunk, int warp_chunks, int dim, int k) {
  constexpr bool WORDS = L > 0;
  constexpr int R = WORDS ? 32 / L : 1;  // id rows a warp load (WORDS)
  constexpr int NW = WORDS ? L : 1;      // id words of a batch, a lane
  constexpr int EB = 32 / KV;            // edges a group (BYTES)
  constexpr int NR = sizeof(T) / 2;      // a row's 16-byte words a lane
  extern __shared__ uint4 slots_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t c0l =
      ((int64_t)blockIdx.x * kWarpsPerBlock + warp) * warp_chunks;
  if (c0l >= n_chunks) return;  // c0 is uniform across the warp
  const int c0 = (int)c0l;
  const int lo = c0 * chunk;
  const int hi = min(min(c0 + warp_chunks, n_chunks) * chunk, n_edges);
  const int words = dim * (int)sizeof(T) / 16;  // a row's, <= 32 NR
  uint4* row = slots_smem + warp * words;
  const T* rowt = reinterpret_cast<const T*>(row);
  const uint64_t keep = l2_policy(true);
  const uint4 zero = make_uint4(0u, 0u, 0u, 0u);
  // word lane + 32 q of row rr
  auto m_row = [&](int rr, int q) -> uint4 {
    const int wd = lane + 32 * q;
    return (wd < words && rr < n_rows) ? __ldcs(m + (int64_t)rr * words + wd)
                                       : zero;
  };
  int r = chunk_row0[c0];  // the row of edge lo
  int wb = r;              // indptr[wb + lane] across the lanes
  int ipw = __ldg(indptr + min(wb + lane, n_rows));
  auto ip = [&](int i) -> int {  // indptr[i], i >= wb, uniform
    if (i - wb >= 32) {
      wb = i;
      ipw = __ldg(indptr + min(wb + lane, n_rows));
    }
    return __shfl_sync(kFull, ipw, i - wb);
  };
  int re = ip(r + 1);
#pragma unroll
  for (int q = 0; q < NR; ++q)
    if (lane + 32 * q < words) row[lane + 32 * q] = m_row(r, q);
  int ahead = r + 1;  // the row in `next`
  uint4 next[NR];
#pragma unroll
  for (int q = 0; q < NR; ++q) next[q] = m_row(ahead, q);
  __syncwarp();
  unsigned fold = 0u;  // MODE 1's word

  // edge e reaches the next row with edges: m[r] into the warp's row
  auto advance = [&](int e) {
    do {
      ++r;
      re = ip(r + 1);
    } while (re <= e);
    __syncwarp();
#pragma unroll
    for (int q = 0; q < NR; ++q)
      if (lane + 32 * q < words)
        row[lane + 32 * q] = r == ahead ? next[q] : m_row(r, q);
    __syncwarp();
    ahead = r + 1;
#pragma unroll
    for (int q = 0; q < NR; ++q) next[q] = m_row(ahead, q);
  };
  // edge e's slot at position p from its ids c[0..KV) for this lane
  auto store = [&](int64_t p, const unsigned* c) {
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      const int j = lane + 32 * t;
      if (j < k) {
        if constexpr (MODE == 1)
          fold ^= rowt[c[t]] + (unsigned)p;  // bf16 terms only
        else
          __stcs(slots + p * k + j, rowt[c[t]]);
      }
    }
  };
  auto src_at = [&](int e) -> int { return e < hi ? __ldcs(indices + e) : 0; };
  auto pos_at = [&](int e) -> int { return e < hi ? __ldcs(perm + e) : 0; };

  if constexpr (WORDS) {
    // the batch at edges [b, b + 32): lane l of load q holds word l % L of
    // the id row of edge b + q R + l / L (sources vb, lane (e - b) % 32)
    auto ids = [&](unsigned (&w)[NW], int vb, int b) {
      const int sub = lane / L, wd = lane % L;
#pragma unroll
      for (int q = 0; q < NW; ++q) {
        const int64_t v = __shfl_sync(kFull, vb, q * R + sub);
        w[q] = (MODE != 3 && 4 * wd < k && b + q * R + sub < hi)
                   ? ld_hint(reinterpret_cast<const unsigned*>(ch + v * k) +
                                 wd, keep)
                   : 0u;
      }
    };
    auto put = [&](const unsigned (&w)[NW], int pb, int b) {
      const int n = min(32, hi - b);
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        if (i < n) {  // uniform across the warp
          const int e = b + i;
          const int64_t p = MODE == 2 ? (int64_t)e
                                      : (int64_t)__shfl_sync(kFull, pb, i);
          if (e >= re) advance(e);
          unsigned c[KV];  // channel j = lane + 32 t: word j / 4, byte j % 4
#pragma unroll
          for (int t = 0; t < KV; ++t) {
            const unsigned wd = __shfl_sync(kFull, w[i / R],
                                            (i % R) * L + (lane >> 2) + 8 * t);
            c[t] = MODE == 3 ? (unsigned)(lane + 32 * t)
                             : (wd >> (8 * (lane & 3))) & 0xffu;
          }
          store(p, c);
        }
      }
    };
    int vl = src_at(lo + lane), pl = pos_at(lo + lane);
    int vn = src_at(lo + 32 + lane), pn = pos_at(lo + 32 + lane);
    unsigned wa[NW], wb2[NW];
    ids(wa, vl, lo);
    // two batches an iteration, ping-pong: the next batch's ids are loaded
    // before this batch's slots are written
    for (int b = lo; b < hi; b += 64) {
      if (b + 32 < hi) ids(wb2, vn, b + 32);
      put(wa, pl, b);
      vl = vn, pl = pn;
      vn = src_at(b + 64 + lane), pn = pos_at(b + 64 + lane);
      if (b + 32 >= hi) break;
      if (b + 64 < hi) ids(wa, vn, b + 64);
      put(wb2, pl, b + 32);
      vl = vn, pl = pn;
      vn = src_at(b + 96 + lane), pn = pos_at(b + 96 + lane);
    }
  } else {
    for (int b = lo; b < hi; b += 32) {
      const int vl = src_at(b + lane), pl = pos_at(b + lane);
      for (int g0 = 0; g0 < 32 && b + g0 < hi; g0 += EB) {
        unsigned c[EB][KV];
#pragma unroll
        for (int i = 0; i < EB; ++i) {
          const int64_t v = __shfl_sync(kFull, vl, g0 + i);
#pragma unroll
          for (int t = 0; t < KV; ++t) {
            const int j = lane + 32 * t;
            c[i][t] = MODE == 3 ? (unsigned)j
                      : (j < k && b + g0 + i < hi)
                          ? ld_hint(ch + v * k + j, keep) : 0u;
          }
        }
#pragma unroll
        for (int i = 0; i < EB; ++i) {
          const int e = b + g0 + i;
          const int64_t p = MODE == 2 ? (int64_t)e
                                      : (int64_t)__shfl_sync(kFull, pl,
                                                             g0 + i);
          if (e < hi) {  // uniform across the warp
            if (e >= re) advance(e);
            store(p, c[i]);
          }
        }
      }
    }
  }
  if constexpr (MODE == 1)
    if (fold == 0x9e3779b9u) slots[lane] = 0;  // keeps the loads
}

// stream_sspmm's pass 2: B3's walk over Aᵀ's spans (SpanRows: the same
// row rules, carry slots and span heads) reading each edge's k terms from
// its slot in order. The slots of TE edges (one tile of at most 2 KB: 32
// edges at k <= 32 for bf16 terms, 16 for f32 ones) come by cp.async into
// a ring of S tiles in the warp's shared memory, S tiles ahead; an edge is
// then a shared-memory load and an fma a lane (lane j, term j), with the
// segment test, and no global load of the terms. (The first version ran
// stream_walk_kernel's one-edge step over the slots: 10.1 ms against this
// loop's 4.0 at ogbn-products, k 32, held by the step's instructions; S = 4
// measured slower than 2, utils/stream_sweep.py, PERF.md.) An edge's factor
// is 1 for bf16 terms (the messages carry it); for f32 terms pre[u] of its
// source u (Aᵀ's indices), the ids two batches of 32 edges ahead and the
// factors one batch ahead in registers (B3's loads). The sums, their order and what is written are those of
// SampledRows (so B3's, bit for bit).
template <class T, int KV>
__host__ __device__ constexpr int tile_edges() {  // pass 2's: <= 2 KB at k
  return 32 / KV / (int)(sizeof(T) / 2);
}

template <class T, int KV, int S, bool OUT16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sspmm_walk_kernel(const Walk w, const typename SampledRows<KV, T>::Src src) {
  constexpr int TE = tile_edges<T, KV>();
  constexpr bool F32 = sizeof(T) == 4;
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
  const int k = src.k;
  const int dim4 = src.dim / 4;
  const int slot_bytes = k * (int)sizeof(T);
  // a tile's bytes, and a stage's: one 16-byte word more, for a tile that
  // does not start on a 16-byte boundary
  const int stage16 = (TE * slot_bytes + 15) / 16 + 1;
  float4* staging = walk_smem + warp * (dim4 + S * stage16);
  float4* ring = staging + dim4;
  const uint64_t drop = l2_policy(false);
  const char* bytes = reinterpret_cast<const char*>(src.slots);
  SampledRows<KV, T> op(src, staging, w.dim4, lane);

  // the tile of edges [b, b + TE) into stage s % S (16-byte words from the
  // one that holds its first byte; past the last edge the slots buffer is
  // padded by 16 bytes); one commit group a tile
  auto fetch = [&](int s, int b) {
    if (b < hi) {
      const int64_t start = (int64_t)b * slot_bytes;
      const int64_t end = (int64_t)min(b + TE, hi) * slot_bytes;
      const int64_t a0 = start & ~(int64_t)15;
      const int words = (int)((end - a0 + 15) / 16);
      const unsigned dst = smem_addr(ring + (s % S) * stage16);
      for (int q = lane; q < words; q += 32)
        cp16(dst + 16 * q, bytes + a0 + 16 * q, 0u, drop, drop);
    }
    cp_commit();
  };
#pragma unroll
  for (int s = 0; s < S; ++s) fetch(s, lo + s * TE);

  // f32 terms, factors from Aᵀ's indices: edge base + lane's factor (cs),
  // base + 32 + lane's (ns) and base + 64 + lane's id (nnu), base the
  // current batch of 32 edges
  const bool gather = F32 && w.pre != nullptr;
  auto id_at = [&](int e) -> int { return e < hi ? __ldcs(w.indices + e) : 0; };
  auto pre_at = [&](int u, int e) -> float {
    return e < hi ? __ldg(w.pre + u) : 1.f;
  };
  float cs = 1.f, ns = 1.f;
  int nnu = 0;
  if (gather) {
    cs = pre_at(id_at(lo + lane), lo + lane);
    ns = pre_at(id_at(lo + 32 + lane), lo + 32 + lane);
    nnu = id_at(lo + 64 + lane);
  }

  SpanRows rows(w, c0, lo, hi, lane);
  int s = 0;
  for (int base = lo; base < hi; base += TE, ++s) {
    if (gather && base > lo && ((base - lo) & 31) == 0) {  // the next batch
      cs = ns;
      ns = pre_at(nnu, base + 32 + lane);
      nnu = id_at(base + 64 + lane);
    }
    cp_wait<S - 1>();  // tile s has landed (one group a tile)
    __syncwarp();
    const T* tile = reinterpret_cast<const T*>(
        reinterpret_cast<const char*>(ring + (s % S) * stage16) +
        (((int64_t)base * slot_bytes) & 15));
    const int n = min(TE, hi - base);
    for (int i = 0; i < n; ++i) {
      float f = 1.f;
      if constexpr (F32)
        f = gather ? __shfl_sync(kFull, cs, (base - lo + i) & 31) : 1.f;
#pragma unroll
      for (int t = 0; t < KV; ++t) {
        const int j = lane + 32 * t;
        if (j < k) op.acc[t] = fmaf(f, term(tile[i * k + j]), op.acc[t]);
      }
      if (base + i + 1 == rows.seg_end) rows.end_segment<OUT16>(op, base + i);
    }
    __syncwarp();  // every lane is done with the stage
    fetch(s + S, base + S * TE);
  }
}

unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <class Op, int D, bool OUT16 = false>
void launch_walk(const Walk& w, const typename Op::Src& src, cudaStream_t s) {
  if (w.n_chunks == 0) return;
  const int64_t warps = (w.n_chunks + w.warp_chunks - 1) / w.warp_chunks;
  const size_t smem =
      (size_t)kWarpsPerBlock * Op::smem4(src, w.dim4) * sizeof(float4);
  stream_walk_kernel<Op, D, OUT16>
      <<<blocks_for(warps), kWarpsPerBlock * 32, smem, s>>>(w, src);
}

// the carry pass over the walk's w.carry (and, OUT16, w.heads and w.y16;
// SAMPLED, w.heads, the rows' channels ch [n_rows, k] and dense rows of
// dim4d float4s)
template <bool OUT16 = false, bool SAMPLED = false>
void launch_carry(int nv, const Walk& w, const int* carry_rows,
                  int64_t n_carry, cudaStream_t s,
                  const uint8_t* ch = nullptr, int k = 0, int dim4d = 0) {
  if (n_carry == 0) return;
  const unsigned blocks = blocks_for(n_carry);
  const int threads = kWarpsPerBlock * 32;
#define CARRY(NV_)                                                          \
  stream_carry_kernel<NV_, OUT16, SAMPLED><<<blocks, threads, 0, s>>>(      \
      w.indptr, carry_rows, w.post, w.carry, w.y, w.heads, w.y16, n_carry, \
      w.chunk, w.warp_chunks, w.dim4, ch, k, dim4d)
  if (nv <= 1)
    CARRY(1);
  else if constexpr (SAMPLED)  // a sampled row: k < 256 sums, nv <= 2
    CARRY(2);
  else if (nv <= 2)
    CARRY(2);
  else if (nv <= 4)
    CARRY(4);
  else
    CARRY(8);
#undef CARRY
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
  w.y16 = nullptr;
  w.heads = nullptr;
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
  launch_carry(nv, w, static_cast<const int*>(carry_rows), n_carry, s);
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
  launch_carry(dim4 <= 32 ? 1 : 2, w, static_cast<const int*>(carry_rows),
               n_carry, s);
  return (int)cudaGetLastError();
}

namespace {

// The bf16-row product; OUT16: y is y16 bf16 [n_rows, dim], heads f32
// [ceil(n_chunks / warp_chunks), dim].
template <bool OUT16>
int spmm16(const void* indptr, const void* indices, const void* x,
           const void* pre, const void* post, const void* chunk_row0,
           const void* carry_rows, const void* hot, void* y, void* carry,
           void* heads, int64_t n_rows, int64_t n_chunks, int64_t n_carry,
           int64_t n_edges, int chunk, int dim, int depth, int warp_chunks,
           void* stream) {
  if (dim < 8 || dim % 8 != 0 || dim > 1024 || chunk < 1 || chunk > 512 ||
      warp_chunks < 1 || !fits_int(n_rows, n_edges) ||
      (OUT16 && heads == nullptr && n_chunks > 0))
    return (int)cudaErrorInvalidValue;
  const int dim4 = dim / 4;
  const int nv = slices(dim / 8);
  Walk w = make_walk(indptr, indices, pre, post, chunk_row0, hot,
                     OUT16 ? nullptr : y, carry, n_rows, n_chunks, n_edges,
                     chunk, warp_chunks, dim4);
  if (OUT16) {
    w.y16 = static_cast<uint2*>(y);
    w.heads = static_cast<float4*>(heads);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint4* xp = static_cast<const uint4*>(x);
#define DENSE16(NV_, D_) launch_walk<Bf16Rows<NV_>, D_, OUT16>(w, {xp}, s)
  if (nv == 1 && depth == 4)
    DENSE16(1, 4);
  else if (nv == 1 && depth == 8)
    DENSE16(1, 8);
  else if (nv == 1 && depth == 16)
    DENSE16(1, 16);
  else if (nv == 2 && depth == 4)
    DENSE16(2, 4);
  else if (nv == 2 && depth == 8)
    DENSE16(2, 8);
  else if (nv == 2 && depth == 16)
    DENSE16(2, 16);
  else if (nv == 4 && depth == 4)
    DENSE16(4, 4);
  else
    return (int)cudaErrorInvalidValue;
#undef DENSE16
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_carry<OUT16>(slices(dim4), w, static_cast<const int*>(carry_rows),
                      n_carry, s);
  return (int)cudaGetLastError();
}

// The instance of stream_cbsr16_kernel for (k, batch, mode) and its
// dynamic shared memory at dim4: batch edges in flight (S EPS: 32 at
// k <= 32, 16 at k <= 64, 8 at k <= 128, 4 above); mode 0 the product, 1
// or 2 a timing variant (k <= 32). kernel is null for any other batch.
using Cbsr16Fn = void (*)(const Walk, const unsigned*);
struct Cbsr16Kernel {
  Cbsr16Fn kernel;
  size_t smem;
};

template <bool OUT16>
Cbsr16Kernel cbsr16_kernel(int k, int dim4, int batch, int mode) {
  const int kv = slices(k);
#define CBSR16(KV_, S_, M_)                                            \
  return {stream_cbsr16_kernel<KV_, S_, OUT16, M_>,                    \
          (size_t)kWarpsPerBlock *                                     \
              (dim4 * 16 + S_ * (KV_ >= 4 ? 1 : 4 / KV_) * 128 * KV_)}
  if (kv == 1 && batch == 32 && mode == 0) CBSR16(1, 8, 0);
  if (kv == 1 && batch == 32 && mode == 1) CBSR16(1, 8, 1);
  if (kv == 1 && batch == 32 && mode == 2) CBSR16(1, 8, 2);
  if (kv == 2 && batch == 16 && mode == 0) CBSR16(2, 8, 0);
  if (kv == 4 && batch == 8 && mode == 0) CBSR16(4, 8, 0);
  if (kv == 8 && batch == 4 && mode == 0) CBSR16(8, 4, 0);
#undef CBSR16
  return {nullptr, 0};
}

// The bf16-record product; OUT16 as in spmm16, batch and mode as in
// cbsr16_kernel.
template <bool OUT16>
int cbsr16(const void* indptr, const void* indices, const void* records,
           const void* pre, const void* post, const void* chunk_row0,
           const void* carry_rows, const void* hot, void* y, void* carry,
           void* heads, int64_t n_rows, int64_t n_chunks, int64_t n_carry,
           int64_t n_edges, int chunk, int k, int dim, int batch,
           int warp_chunks, int mode, void* stream) {
  if (dim < 4 || dim % 4 != 0 || dim > 256 || k < 1 || k >= dim ||
      pre != nullptr || chunk < 1 || chunk > 512 || warp_chunks < 1 ||
      !fits_int(n_rows, n_edges) ||
      (OUT16 && heads == nullptr && n_chunks > 0))
    return (int)cudaErrorInvalidValue;
  const int dim4 = dim / 4;
  const Cbsr16Kernel kn = cbsr16_kernel<OUT16>(k, dim4, batch, mode);
  if (kn.kernel == nullptr) return (int)cudaErrorInvalidValue;
  Walk w = make_walk(indptr, indices, nullptr, post, chunk_row0, hot,
                     OUT16 ? nullptr : y, carry, n_rows, n_chunks, n_edges,
                     chunk, warp_chunks, dim4);
  if (OUT16) {
    w.y16 = static_cast<uint2*>(y);
    w.heads = static_cast<float4*>(heads);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t warps = (n_chunks + warp_chunks - 1) / warp_chunks;
  if (n_chunks > 0)
    kn.kernel<<<blocks_for(warps), kWarpsPerBlock * 32, kn.smem, s>>>(
        w, static_cast<const unsigned*>(records));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  launch_carry<OUT16>(dim4 <= 32 ? 1 : 2, w,
                      static_cast<const int*>(carry_rows), n_carry, s);
  return (int)cudaGetLastError();
}

}  // namespace

// stream_spmm on x bf16 [n_src, dim] (the rows of round_rows), as
// stream_spmm otherwise: depth 4, 8 or 16 at dim <= 512, 4 at dim <= 1024.
// Needs dim % 8 == 0, dim <= 1024 and 16-byte aligned x, y and carry.
extern "C" int stream_spmm_bf16(const void* indptr, const void* indices,
                                const void* x, const void* pre,
                                const void* post, const void* chunk_row0,
                                const void* carry_rows, const void* hot,
                                void* y, void* carry, int64_t n_rows,
                                int64_t n_chunks, int64_t n_carry,
                                int64_t n_edges, int chunk, int dim,
                                int depth, int warp_chunks, void* stream) {
  return spmm16<false>(indptr, indices, x, pre, post, chunk_row0, carry_rows,
                       hot, y, carry, nullptr, n_rows, n_chunks, n_carry,
                       n_edges, chunk, dim, depth, warp_chunks, stream);
}

// stream_spmm_bf16 with y16 bf16 [n_rows, dim] <- bf16(bf16(A (pre * x)) *
// bf16(post)); heads f32 [ceil(n_chunks / warp_chunks), dim] scratch, the
// first-span sums of the rows across spans. Needs 16-byte aligned x, y16,
// carry and heads; otherwise as stream_spmm_bf16.
extern "C" int stream_spmm_bf16_out(const void* indptr, const void* indices,
                                    const void* x, const void* pre,
                                    const void* post, const void* chunk_row0,
                                    const void* carry_rows, const void* hot,
                                    void* y16, void* carry, void* heads,
                                    int64_t n_rows, int64_t n_chunks,
                                    int64_t n_carry, int64_t n_edges,
                                    int chunk, int dim, int depth,
                                    int warp_chunks, void* stream) {
  return spmm16<true>(indptr, indices, x, pre, post, chunk_row0, carry_rows,
                      hot, y16, carry, heads, n_rows, n_chunks, n_carry,
                      n_edges, chunk, dim, depth, warp_chunks, stream);
}

// stream_cbsr_spmm on records with bf16 values: int32 [n_src, 32 ceil(k /
// 32)], word j the bf16 bits of value j in its high half and channel j in
// its low, zero past k (ops/maxk.py::cbsr_records on bf16 values; 128 B at
// k <= 32); pre must be null (round_rows folds it into the values), and the
// records 16-byte aligned. batch: edges in flight, 32 at k <= 32, 16 at
// k <= 64, 8 at k <= 128, 4 above; mode 0 (1 and 2: the timing variants of
// stream_cbsr16_kernel, k <= 32). Otherwise as stream_cbsr_spmm.
extern "C" int stream_cbsr_spmm_bf16(const void* indptr, const void* indices,
                                     const void* records, const void* pre,
                                     const void* post, const void* chunk_row0,
                                     const void* carry_rows, const void* hot,
                                     void* y, void* carry, int64_t n_rows,
                                     int64_t n_chunks, int64_t n_carry,
                                     int64_t n_edges, int chunk, int k,
                                     int dim, int batch, int warp_chunks,
                                     int mode, void* stream) {
  return cbsr16<false>(indptr, indices, records, pre, post, chunk_row0,
                       carry_rows, hot, y, carry, nullptr, n_rows, n_chunks,
                       n_carry, n_edges, chunk, k, dim, batch, warp_chunks,
                       mode, stream);
}

// stream_cbsr_spmm_bf16 with a bf16 y16 and the heads scratch, as
// stream_spmm_bf16_out.
extern "C" int stream_cbsr_spmm_bf16_out(
    const void* indptr, const void* indices, const void* records,
    const void* pre, const void* post, const void* chunk_row0,
    const void* carry_rows, const void* hot, void* y16, void* carry,
    void* heads, int64_t n_rows, int64_t n_chunks, int64_t n_carry,
    int64_t n_edges, int chunk, int k, int dim, int batch, int warp_chunks,
    int mode, void* stream) {
  return cbsr16<true>(indptr, indices, records, pre, post, chunk_row0,
                      carry_rows, hot, y16, carry, heads, n_rows, n_chunks,
                      n_carry, n_edges, chunk, k, dim, batch, warp_chunks,
                      mode, stream);
}

namespace {

// pass 2's tiles in flight a warp (2 measured faster than 4)
constexpr int kSampledStages = 2;

template <class T>
using SampledSrc = typename SampledRows<1, T>::Src;

// pass 2 on slots of k terms of T; a block's shared memory: the staging
// rows and S tiles of at most 2 KB of terms a warp, under 48 KB at dim <=
// 256
template <class T, int KV, bool OUT16>
void launch_tiles(const Walk& w, const SampledSrc<T>& src, cudaStream_t s) {
  constexpr int S = kSampledStages;
  if (w.n_chunks == 0) return;
  const int64_t warps = (w.n_chunks + w.warp_chunks - 1) / w.warp_chunks;
  const int stage16 =
      (tile_edges<T, KV>() * src.k * (int)sizeof(T) + 15) / 16 + 1;
  const size_t smem = (size_t)kWarpsPerBlock * (src.dim / 4 + S * stage16) *
                      sizeof(float4);
  sspmm_walk_kernel<T, KV, S, OUT16>
      <<<blocks_for(warps), kWarpsPerBlock * 32, smem, s>>>(
          w, {src.slots, src.m, src.edge_row, src.ch, src.k, src.dim});
}

// pass 2 of stream_sspmm_bf16 at k (mode 0) or the gather probe (mode 1, k
// <= 32), OUT16 as in spmm16: false when (k, mode) has no instance
template <bool OUT16>
bool launch_sampled(const Walk& w, const SampledSrc<uint16_t>& src, int mode,
                    cudaStream_t s) {
  const int kv = slices(src.k);
  if (mode == 0 && kv == 1) launch_tiles<uint16_t, 1, OUT16>(w, src, s);
  else if (mode == 0 && kv == 2)
    launch_tiles<uint16_t, 2, OUT16>(w, src, s);
  else if (mode == 0 && kv == 4)
    launch_tiles<uint16_t, 4, OUT16>(w, src, s);
  else if (mode == 0 && kv == 8)
    launch_tiles<uint16_t, 8, OUT16>(w, src, s);
  else if (mode == 1 && kv == 1)
    launch_walk<SampledRows<1>, 16, OUT16>(w, src, s);
  else return false;
  return true;
}

// pass 1's checks: rows of dim T values (16-byte words: dim % 8 == 0 for
// bf16, dim % 4 == 0 for f32), dim <= 256 (uint8 ids), 1 <= k < dim
template <class T>
bool slots_args_ok(int64_t n_rows, int64_t n_edges, int chunk,
                   int warp_chunks, int dim, int k) {
  const int step = 16 / (int)sizeof(T);
  return dim >= step && dim % step == 0 && dim <= 256 && k >= 1 && k < dim &&
         chunk >= 1 && chunk <= 512 && warp_chunks >= 1 &&
         fits_int(n_rows, n_edges);
}

// pass 1 (sspmm_slots_kernel) on rows of T at (k, mode), slots of k terms
template <class T>
int launch_slots(const void* indptr, const void* indices,
                 const void* chunk_row0, const void* perm, const void* m,
                 const void* ch, void* slots, int64_t n_rows,
                 int64_t n_chunks, int64_t n_edges, int chunk,
                 int warp_chunks, int dim, int k, int mode, void* stream) {
  if (n_chunks == 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t warps = (n_chunks + warp_chunks - 1) / warp_chunks;
  const size_t smem = (size_t)kWarpsPerBlock * dim * sizeof(T);
  // WORDS: L lanes an id row, k / 4 rounded up to a power of two
  const int lanes = k % 4 || k > 128 ? 0
                    : k <= 4 ? 1 : k <= 8 ? 2 : k <= 16 ? 4 : k <= 32 ? 8
                    : k <= 64 ? 16 : 32;
  const int kv = slices(k);
#define SLOTS(KV_, L_, M_)                                                  \
  sspmm_slots_kernel<T, KV_, L_, M_>                                   \
      <<<blocks_for(warps), kWarpsPerBlock * 32, smem, s>>>(           \
          static_cast<const int*>(indptr),                             \
          static_cast<const int*>(indices),                            \
          static_cast<const int*>(chunk_row0),                         \
          static_cast<const int*>(perm), static_cast<const uint4*>(m), \
          static_cast<const uint8_t*>(ch), static_cast<T*>(slots),     \
          (int)n_rows, (int)n_chunks, (int)n_edges, chunk, warp_chunks, \
          dim, k)
  if (lanes == 8 && mode == 0)
    SLOTS(1, 8, 0);
  else if (mode != 0) {  // the timing variants: bf16 rows, k 20 to 32
    if constexpr (sizeof(T) == 2) {
      if (lanes == 8 && mode == 1)
        SLOTS(1, 8, 1);
      else if (lanes == 8 && mode == 2)
        SLOTS(1, 8, 2);
      else if (lanes == 8 && mode == 3)
        SLOTS(1, 8, 3);
      else
        return (int)cudaErrorInvalidValue;
    } else {
      return (int)cudaErrorInvalidValue;
    }
  } else if (lanes == 1)
    SLOTS(1, 1, 0);
  else if (lanes == 2)
    SLOTS(1, 2, 0);
  else if (lanes == 4)
    SLOTS(1, 4, 0);
  else if (lanes == 16)
    SLOTS(2, 16, 0);
  else if (lanes == 32)
    SLOTS(4, 32, 0);
  else if (kv == 1)
    SLOTS(1, 0, 0);
  else if (kv == 2)
    SLOTS(2, 0, 0);
  else if (kv == 4)
    SLOTS(4, 0, 0);
  else
    SLOTS(8, 0, 0);
#undef SLOTS
  return (int)cudaGetLastError();
}

// the carry pass of a sampled backward (f32 or, out16, bf16 output)
int sampled_carry(const Walk& w, bool out16, const void* carry_rows,
                  int64_t n_carry, const uint8_t* ch, int k, int dim,
                  cudaStream_t s) {
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int* cr = static_cast<const int*>(carry_rows);
  const int kw4 = (k + 3) / 4;
  if (out16)
    launch_carry<true, true>(slices(kw4), w, cr, n_carry, s, ch, k, dim / 4);
  else
    launch_carry<false, true>(slices(kw4), w, cr, n_carry, s, ch, k,
                              dim / 4);
  return (int)cudaGetLastError();
}

}  // namespace

// stream_sspmm_bf16's pass 1 (sspmm_slots_kernel): slots bf16 [n_edges, k]
// <- for each edge e of A's StreamPlan (indptr int32 [n_rows + 1], indices
// int32 [n_edges], chunk_row0 int32 [n_chunks], warp spans of warp_chunks
// chunks), m[row(e), ch[indices[e], j]] at slot perm[e] (int32 [n_edges],
// e's position in Aᵀ's edge order); m bf16 [n_rows, dim], ch uint8
// [n_src, k]. mode 0; 1-3 the timing variants of sspmm_slots_kernel (k
// 32).
// Needs dim % 8 == 0, 8 <= dim <= 256, 1 <= k < dim, 1 <= chunk <= 512
// and a 16-byte aligned m.
extern "C" int sspmm_slots_bf16(const void* indptr, const void* indices,
                                const void* chunk_row0, const void* perm,
                                const void* m, const void* ch, void* slots,
                                int64_t n_rows, int64_t n_chunks,
                                int64_t n_edges, int chunk, int warp_chunks,
                                int dim, int k, int mode, void* stream) {
  if (!slots_args_ok<uint16_t>(n_rows, n_edges, chunk, warp_chunks, dim, k) ||
      mode < 0 || mode > 3)
    return (int)cudaErrorInvalidValue;
  return launch_slots<uint16_t>(indptr, indices, chunk_row0, perm, m, ch,
                                slots, n_rows, n_chunks, n_edges, chunk,
                                warp_chunks, dim, k, mode, stream);
}

// stream_sspmm_bf16's pass 2 and carry pass over Aᵀ's StreamPlan (indptr,
// chunk_row0, carry_rows as in stream_spmm; indices read by mode 1 only):
// y[v, ch[v, j]] <- post[v] * sum over v's edges e of slots[e k + j], in
// B3's order (the sums of stream_spmm_bf16 on the messages at those
// channels), and 0 at the row's other channels; y f32 [n_rows, dim], or
// with out16 bf16 = bf16(bf16(sum) * bf16(post)) (stream_spmm_bf16_out's).
// slots bf16 [n_edges, k] and 16 bytes more; carry f32 [n_chunks, 4
// ceil(k / 4)] and heads f32 [ceil(n_chunks / warp_chunks), 4 ceil(k / 4)]
// scratch. mode 0 reads slots (pass 1's); mode 1, the k-channel gather
// probe (k <= 32), gathers each term from the messages m bf16 [n_src, dim]
// at the edge's source (indices) and row (edge_row int32 [n_edges]) on
// stream_walk_kernel, with hot as in stream_spmm at the row size of m: the
// same sums. Needs dim % 8 == 0, 8 <= dim <= 256, 1 <= k < dim, 1 <= chunk
// <= 512 and 16-byte aligned y, carry and heads.
extern "C" int stream_sspmm_bf16(
    const void* indptr, const void* indices, const void* chunk_row0,
    const void* carry_rows, const void* slots, const void* m,
    const void* edge_row, const void* ch, const void* post, const void* hot,
    void* y, void* carry, void* heads, int64_t n_rows, int64_t n_chunks,
    int64_t n_carry, int64_t n_edges, int chunk, int warp_chunks, int dim,
    int k, int out16, int mode, void* stream) {
  if (!slots_args_ok<uint16_t>(n_rows, n_edges, chunk, warp_chunks, dim, k) ||
      (heads == nullptr && n_chunks > 0) || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  Walk w = make_walk(indptr, indices, nullptr, post, chunk_row0,
                     mode == 1 ? hot : nullptr, out16 ? nullptr : y, carry,
                     n_rows, n_chunks, n_edges, chunk, warp_chunks,
                     (k + 3) / 4);
  if (out16) w.y16 = static_cast<uint2*>(y);
  w.heads = static_cast<float4*>(heads);
  const SampledSrc<uint16_t> src{
      static_cast<const uint16_t*>(slots), static_cast<const uint16_t*>(m),
      static_cast<const int*>(edge_row), static_cast<const uint8_t*>(ch), k,
      dim};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ok = out16 ? launch_sampled<true>(w, src, mode, s)
                        : launch_sampled<false>(w, src, mode, s);
  if (!ok) return (int)cudaErrorInvalidValue;
  return sampled_carry(w, out16, carry_rows, n_carry, src.ch, k, dim, s);
}

// stream_sspmm's pass 1 on f32 messages: slots f32 [n_edges, k] <- for
// each edge e of A's StreamPlan (as in sspmm_slots_bf16), the raw terms
// g[row(e), ch[indices[e], j]] at slot perm[e]; g f32 [n_rows, dim] (the
// cotangent, no factor in it). Needs dim % 4 == 0, 4 <= dim <= 256, 1 <= k
// < dim, 1 <= chunk <= 512 and a 16-byte aligned g.
extern "C" int sspmm_slots_f32(const void* indptr, const void* indices,
                               const void* chunk_row0, const void* perm,
                               const void* g, const void* ch, void* slots,
                               int64_t n_rows, int64_t n_chunks,
                               int64_t n_edges, int chunk, int warp_chunks,
                               int dim, int k, void* stream) {
  if (!slots_args_ok<float>(n_rows, n_edges, chunk, warp_chunks, dim, k))
    return (int)cudaErrorInvalidValue;
  return launch_slots<float>(indptr, indices, chunk_row0, perm, g, ch, slots,
                             n_rows, n_chunks, n_edges, chunk, warp_chunks,
                             dim, k, 0, stream);
}

// stream_sspmm's pass 2 and carry pass on f32 slots, over Aᵀ's StreamPlan
// (indptr, indices, chunk_row0, carry_rows as in stream_spmm): y[v, ch[v,
// j]] <- post[v] * the sum over v's edges e, source u = indices[e], of
// pre[u] * slots[e k + j], each term an fma in B3's order (stream_spmm's
// sums on g with pre and post at those channels, bit for bit), and 0 at the
// row's other channels; y f32 [n_rows, dim]; pre f32 [n_src] and post f32
// [n_rows], or null. slots f32 [n_edges, k] and 16 bytes more; carry and
// heads as in stream_sspmm_bf16. Needs dim % 4 == 0, 4 <= dim <= 256, 1 <= k < dim,
// 1 <= chunk <= 512 and 16-byte aligned y, carry and heads.
extern "C" int stream_sspmm_f32(
    const void* indptr, const void* indices, const void* chunk_row0,
    const void* carry_rows, const void* slots, const void* ch,
    const void* pre, const void* post, void* y, void* carry, void* heads,
    int64_t n_rows, int64_t n_chunks, int64_t n_carry, int64_t n_edges,
    int chunk, int warp_chunks, int dim, int k, void* stream) {
  if (!slots_args_ok<float>(n_rows, n_edges, chunk, warp_chunks, dim, k) ||
      (heads == nullptr && n_chunks > 0))
    return (int)cudaErrorInvalidValue;
  Walk w = make_walk(indptr, indices, pre, post, chunk_row0, nullptr, y,
                     carry, n_rows, n_chunks, n_edges, chunk, warp_chunks,
                     (k + 3) / 4);
  w.heads = static_cast<float4*>(heads);
  const SampledSrc<float> src{static_cast<const float*>(slots), nullptr,
                              nullptr, static_cast<const uint8_t*>(ch), k,
                              dim};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kv = slices(k);
  if (kv == 1)
    launch_tiles<float, 1, false>(w, src, s);
  else if (kv == 2)
    launch_tiles<float, 2, false>(w, src, s);
  else if (kv == 4)
    launch_tiles<float, 4, false>(w, src, s);
  else
    launch_tiles<float, 8, false>(w, src, s);
  return sampled_carry(w, false, carry_rows, n_carry, src.ch, k, dim, s);
}

// The kernel that stream_cbsr_spmm_bf16 (out16 0) or _out (1) runs at (k,
// dim, batch, mode): int32 out[3] = its registers a thread, local (spill)
// bytes a thread, resident blocks an SM. Launches nothing.
extern "C" int stream_cbsr16_attrs(int k, int dim, int batch, int mode,
                                   int out16, void* out) {
  if (dim < 4 || dim % 4 != 0 || dim > 256 || k < 1 || k >= dim)
    return (int)cudaErrorInvalidValue;
  const Cbsr16Kernel kn =
      out16 ? cbsr16_kernel<true>(k, dim / 4, batch, mode)
            : cbsr16_kernel<false>(k, dim / 4, batch, mode);
  if (kn.kernel == nullptr) return (int)cudaErrorInvalidValue;
  int* o = static_cast<int*>(out);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kn.kernel);
  if (err != cudaSuccess) return (int)err;
  o[0] = a.numRegs;
  o[1] = (int)a.localSizeBytes;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &o[2], kn.kernel, kWarpsPerBlock * 32, kn.smem);
}
