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
// carry slots, y and post stay f32. The walk, the carry pass, the hot set
// (at the 16-bit row or record size) and the L2 hints are the f32 kernels'.
// A dense row is 512 B at dim 256 (a lane loads 16 B, 8 channels), so the
// no-reuse gather falls to E * 512 B, about 63 GB or 19 ms at ogbn-products,
// and the same L2 budget holds twice the hot rows. A record holds ceil(k / 2)
// words of bf16 values (two to a word) and the packed ids: 96 B at k 32,
// three 32-byte sectors instead of five. Its lanes load the record as
// 32-bit words, one load per lane at k <= 32, and take their value and id
// from it with shuffles. A first version loaded each value with a 16-bit
// load and read 16.1 ms on ogbn-products, slower than the f32 records
// (utils/stream_sweep.py; PERF.md has both designs' times).
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

  __device__ __forceinline__ void load(Slot& sl, int u, uint64_t pol) const {
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

  __device__ __forceinline__ void write16(uint2* out, float p) const {
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int q = lane + 32 * t;
      if (q < dim4) __stcs(out + q, round_out(head[t], p));
    }
  }
};

// stream_cbsr_spmm_bf16's rows: CbsrRecords' accumulator, sums and writes
// over a record of vw = ceil(k / 2) words of bf16 values (value 2i in the
// low half of word i) and kp packed id words (rw16 = vw + kp words). Lane l
// loads record words l, l + 32, ... (kW of them: one at k <= 32), and slot
// j = lane + 32 t takes its value, the half j & 1 of word j / 2, and its id,
// byte j & 3 of word vw + j / 4, from those words with shuffles; a value
// widens exactly to f32 and is scattered as CbsrRecords' is.
template <int KV>
struct Cbsr16Records : CbsrRecords<KV, true> {
  using Base = CbsrRecords<KV, true>;
  static constexpr int kW = (3 * KV + 3) / 4;  // ceil(24 KV / 32) words
  struct Src {
    const unsigned* rec;
    int k, kp;
  };
  struct Slot {
    unsigned w[kW];
  };

  int vw, rw16;

  __device__ __forceinline__ Cbsr16Records(const Src& s, float4* smem,
                                           int dim4_, int lane_)
      : Base(typename Base::Src{s.rec, s.k, s.kp}, smem, dim4_, lane_),
        vw((s.k + 1) / 2), rw16((s.k + 1) / 2 + s.kp) {}

  __device__ __forceinline__ void load(Slot& sl, int u, uint64_t pol) const {
    const unsigned* rr = this->rec + (int64_t)u * rw16;
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      const int j = this->lane + 32 * i;
      sl.w[i] = j < rw16 ? ld_hint(rr + j, pol) : 0u;
    }
  }

  __device__ __forceinline__ void consume(const Slot& sl, float s) {
    const int lane = this->lane;
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      // the value: word 16 t + lane / 2, of the words loaded in round t / 2
      const unsigned vwd =
          __shfl_sync(kFull, sl.w[t >> 1], 16 * (t & 1) + (lane >> 1));
      // the id: word q, in round i0 or i0 + 1 (round 0 at k <= 32)
      const int q = vw + 8 * t + (lane >> 2);
      unsigned iw;
      if constexpr (kW == 1) {
        iw = __shfl_sync(kFull, sl.w[0], q);
      } else {
        const int i0 = (vw + 8 * t) >> 5;
        unsigned lo = 0u, hi = 0u;
#pragma unroll
        for (int i = 0; i < kW; ++i) {
          if (i == i0) lo = sl.w[i];
          if (i == i0 + 1) hi = sl.w[i];
        }
        const unsigned a = __shfl_sync(kFull, lo, q & 31);
        const unsigned b = __shfl_sync(kFull, hi, q & 31);
        iw = (q >> 5) == i0 ? a : b;
      }
      const float v = __uint_as_float((lane & 1) ? (vwd & 0xffff0000u)
                                                 : (vwd << 16));
      const unsigned c = (iw >> (8 * (lane & 3))) & 0xffu;
      if (lane + 32 * t < this->k && v != 0.f)
        this->acc[c] = fmaf(s, v, this->acc[c]);
    }
    __syncwarp();
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
            if constexpr (OUT16) {
              if (before)
                op.write(w.carry + (int64_t)q * w.dim4, 1.f);
              else if (re <= qhi)  // the row ends: whole, rounded
                op.write16(w.y16 + (int64_t)r * w.dim4, bf16_round(pr));
              else if (qhi == hi)  // goes on past the span: its span's slot
                op.write(w.heads + (int64_t)(c0 / w.warp_chunks) * w.dim4,
                         1.f);
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
// the bf16 y16.
template <int NV, bool OUT16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
stream_carry_kernel(const int* __restrict__ indptr,
                    const int* __restrict__ carry_rows,
                    const float* __restrict__ post,
                    const float4* __restrict__ carry, float4* __restrict__ y,
                    const float4* __restrict__ heads,
                    uint2* __restrict__ y16, int64_t n_carry, int chunk,
                    int warp_chunks, int dim4) {
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
      OUT16 ? heads + (a / chunk / warp_chunks) * dim4 : yr;
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

unsigned blocks_for(int64_t warps) {
  return (unsigned)((warps + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

template <class Op, int D, bool OUT16 = false>
void launch_walk(const Walk& w, const typename Op::Src& src, cudaStream_t s) {
  if (w.n_chunks == 0) return;
  const int64_t warps = (w.n_chunks + w.warp_chunks - 1) / w.warp_chunks;
  const size_t smem =
      (size_t)kWarpsPerBlock * Op::kSmemFloats * w.dim4 * sizeof(float4);
  stream_walk_kernel<Op, D, OUT16>
      <<<blocks_for(warps), kWarpsPerBlock * 32, smem, s>>>(w, src);
}

// the carry pass over the walk's w.carry (and, OUT16, w.heads and w.y16)
template <bool OUT16 = false>
void launch_carry(int nv, const Walk& w, const int* carry_rows,
                  int64_t n_carry, cudaStream_t s) {
  if (n_carry == 0) return;
  const unsigned blocks = blocks_for(n_carry);
  const int threads = kWarpsPerBlock * 32;
#define CARRY(NV_)                                                          \
  stream_carry_kernel<NV_, OUT16><<<blocks, threads, 0, s>>>(               \
      w.indptr, carry_rows, w.post, w.carry, w.y, w.heads, w.y16, n_carry, \
      w.chunk, w.warp_chunks, w.dim4)
  if (nv <= 1)
    CARRY(1);
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

// The bf16-record product; OUT16 as in spmm16.
template <bool OUT16>
int cbsr16(const void* indptr, const void* indices, const void* records,
           const void* pre, const void* post, const void* chunk_row0,
           const void* carry_rows, const void* hot, void* y, void* carry,
           void* heads, int64_t n_rows, int64_t n_chunks, int64_t n_carry,
           int64_t n_edges, int chunk, int k, int kp, int dim, int batch,
           int warp_chunks, void* stream) {
  if (dim < 4 || dim % 4 != 0 || dim > 256 || k < 1 || k >= dim ||
      kp != (k + 3) / 4 || chunk < 1 || chunk > 512 || warp_chunks < 1 ||
      !fits_int(n_rows, n_edges) ||
      (OUT16 && heads == nullptr && n_chunks > 0))
    return (int)cudaErrorInvalidValue;
  const int dim4 = dim / 4;
  Walk w = make_walk(indptr, indices, pre, post, chunk_row0, hot,
                     OUT16 ? nullptr : y, carry, n_rows, n_chunks, n_edges,
                     chunk, warp_chunks, dim4);
  if (OUT16) {
    w.y16 = static_cast<uint2*>(y);
    w.heads = static_cast<float4*>(heads);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned* rp = static_cast<const unsigned*>(records);
  const int kv = slices(k);
#define CBSR16(KV_, B_) \
  launch_walk<Cbsr16Records<KV_>, B_, OUT16>(w, {rp, k, kp}, s)
  if (kv == 1 && batch == 4)
    CBSR16(1, 4);
  else if (kv == 1 && batch == 8)
    CBSR16(1, 8);
  else if (kv == 1 && batch == 16)
    CBSR16(1, 16);
  else if (kv == 2 && batch == 8)
    CBSR16(2, 8);
  else if (kv == 4 && batch == 4)
    CBSR16(4, 4);
  else if (kv == 8 && batch == 4)
    CBSR16(8, 4);
  else
    return (int)cudaErrorInvalidValue;
#undef CBSR16
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

// stream_cbsr_spmm on records with bf16 values: int32 [n_src, vw + kp],
// vw = ceil(k / 2) words of bf16 values, two to a word (value 2i in the low
// half of word i), then kp = ceil(k / 4) words of uint8 channel ids
// (ops/maxk.py::cbsr_records on bf16 values; 96 B at k 32). batch: 4, 8 or
// 16 at k <= 32, 8 at k <= 64, 4 above. Otherwise as stream_cbsr_spmm.
extern "C" int stream_cbsr_spmm_bf16(const void* indptr, const void* indices,
                                     const void* records, const void* pre,
                                     const void* post, const void* chunk_row0,
                                     const void* carry_rows, const void* hot,
                                     void* y, void* carry, int64_t n_rows,
                                     int64_t n_chunks, int64_t n_carry,
                                     int64_t n_edges, int chunk, int k,
                                     int kp, int dim, int batch,
                                     int warp_chunks, void* stream) {
  return cbsr16<false>(indptr, indices, records, pre, post, chunk_row0,
                       carry_rows, hot, y, carry, nullptr, n_rows, n_chunks,
                       n_carry, n_edges, chunk, k, kp, dim, batch,
                       warp_chunks, stream);
}

// stream_cbsr_spmm_bf16 with a bf16 y16 and the heads scratch, as
// stream_spmm_bf16_out.
extern "C" int stream_cbsr_spmm_bf16_out(
    const void* indptr, const void* indices, const void* records,
    const void* pre, const void* post, const void* chunk_row0,
    const void* carry_rows, const void* hot, void* y16, void* carry,
    void* heads, int64_t n_rows, int64_t n_chunks, int64_t n_carry,
    int64_t n_edges, int chunk, int k, int kp, int dim, int batch,
    int warp_chunks, void* stream) {
  return cbsr16<true>(indptr, indices, records, pre, post, chunk_row0,
                      carry_rows, hot, y16, carry, heads, n_rows, n_chunks,
                      n_carry, n_edges, chunk, k, kp, dim, batch,
                      warp_chunks, stream);
}
