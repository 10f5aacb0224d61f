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

//
// csr_spmm_bf16, the second export, is the bf16 form of the same product:
// the TPU kernel's packed branch (spgemm_pallas.py:124-129, :183-186, two
// bf16 per 32-bit lane, selected by planned_spmm(stream="bf16x2")). Here x
// holds bf16 rows (2 B a channel: 512 B at dim 256), already rounded from
// pre * x by round_rows (csrc/round.cu), so the planner passes no pre. A
// lane loads 16 B, 8 channels, and widens them to f32 in registers (exact:
// bf16 is the top half of f32); sums, scratch, y and post stay f32, and the
// schedule, the fetch, the layers of the sum and the fix-up are the f32
// kernel's. The gather's bytes halve (E dim 2 B, about 58 GB at Reddit), and
// a source block of half of L2 holds twice the rows (graphs/tiles.py sizes
// blocks by row bytes: 5 at Reddit instead of 10).
//
// csr_cbsr_spmm_bf16, the third export, computes the same product on a MaxK
// (k-sparse) input given as one CBSR record per source node: the TPU
// kernel's function composed with densify (spgemm_pallas.py:285
// _densify_t_kernel, call :329, then :97 on bf16 rows), behind the port's
// STREAM_CBSR_FORWARD rule on windowed plans. A record is k bf16 values and
// their channels, one 32-bit word a slot (value bits high, channel low),
// padded to 1, 2, 4 or 8 128-byte lines (ops/maxk.py::cbsr_records; 128 B
// at k <= 32). Bound on this card: memory. Each byte once at Reddit (a
// record of the 96 B the function needs at k 32: k values, k one-byte ids;
// 4-byte indices; f32 y) is about 0.21 ms at 3.35 TB/s, and the edges'
// record gather with no reuse, E * 96 B, about 3.2 ms. csr_spmm_bf16 runs
// below its own no-reuse gather (its source blocks keep the rows it
// gathers in L2) at the rate L2 serves 512-byte rows, 58 GB a call: the
// bytes an edge reads are what this kernel cuts, to one 128-byte record
// (4.18 against 8.49 ms on the H100, PERF.md). Design (csr_cbsr_kernel):
// csr_spmm_bf16's schedule and layers of the sum, unchanged, but not its
// passes: csr_spmm runs one pass a source block because a block's slab of
// dense rows is what fits L2, while all of Reddit's records (29.8 MB bf16,
// 37.3 MB f32) nearly fit it whole. So the blocks are grouped into record
// passes of as many blocks as whose records fit half of L2
// (graphs/tiles.py::RecordWalk: 2 passes at Reddit in bf16 and in f32,
// against 5 and 10 block passes), and a pass is two launches: a warp per
// piece of a split run (its sum to a scratch slot), then a warp per row,
// which walks the row's runs in the pass's blocks in block order, each
// run's sum (a whole run's batches, or a split run's slots in order) added
// to the row's, and writes y once a pass; the block passes' fix-ups and
// their reads and writes of y go. Each sum keeps its order, so y is the
// block passes' bit for bit. On the H100 that took the bf16 form from
// 4.21 to 4.18 ms and the f32 form from 9.22 to 8.72 (PERF.md): the block
// passes' y traffic was mostly hidden under the scatter. A stream of
// records across a row's runs (a lane a run, each id's run found by a
// search over the lanes) measured 4.6-5.2 ms in bf16 and 12.1-15.1 in
// f32, and was dropped: more registers and more work a stage. B8-bf16's
// stage (csrc/stream.cu::stream_cbsr16_kernel) for the records: a warp's
// edges' records are copied by cp.async, 16 bytes a lane
// (four 128-byte records a warp copy), with an L2 evict_last policy into a
// ring of stages in the warp's shared memory, 32 edges ahead; an edge is
// then a shared-memory load a lane (slot j to lane j) and the scatter of
// its nonzero value into a per-warp f32 partial row of dim floats in shared
// memory. The partial holds one batch of 32 edges in edge order, and at
// the batch's end each lane adds its channels of it into the run's sum
// in registers (BF16's layout) and zeroes them: csr_spmm_bf16's batch sum,
// which adds every channel of every edge, only without the additions of an
// exact zero, which leave an f32 sum unchanged (a batch sum starts at +0
// and never becomes -0). So at the same schedule y is csr_spmm_bf16's on
// the densified rows bit for bit.
//
// csr_cbsr_spmm, the f32 form (the MaxK forward of the f32 path on a
// windowed plan, Reddit's canonical recipe; the same composition in f32,
// spgemm_gnn_tpu/kernels/planned.py:198 spgemm_forward with stream_dtype
// f32: densify, then spgemm_pallas.py:97), is csr_cbsr_kernel on f32
// records (ops/maxk.py::cbsr_records: k f32 values, then the uint8 ids
// packed four to a word; 160 B at k 32) at csr_spmm's f32 schedule (10
// source blocks at Reddit, in 2 record passes of 6 and 4). The records are
// not prescaled: as
// csr_segment_kernel applies pre[u] to each f32 row by an FMA, slot j adds
// fmaf(pre[u], v, part[c]), so y is csr_spmm's on the densified rows bit
// for bit (for GCN's deg^-1/2 as for no pre). A record of k % 16 == 0 is a
// whole number of 16-byte chunks (ten at k 32, two records a warp copy);
// another k copies 4 bytes a lane. Bound at Reddit: bytes, indices 453.2
// MB, y 238.6 MB and the records 37.3 MB, 0.218 ms at 3.35 TB/s (the 2 E k
// operations take 0.108 ms); the records' gather with no reuse, E * 160 B,
// 5.41 ms, against the dense form's 1-KB rows read from L2 at 15.4 ms. On
// the H100 it takes 8.72 ms (9.22 in block passes) against csr_spmm's
// 15.49; the records alone, copied over the schedule and not scattered,
// 5.11 (PERF.md). Records of 8-byte slots (256 B) gathered in 5.27 and 16
// stages in flight in 6.14, so the layout and the 8 stages stay.
//
// csr_sspmm_bf16 (with out16 the bf16 output; counted as csr_sspmm_bf16 and
// csr_sspmm_bf16_out) and csr_sspmm (f32 messages) are MaxK's backward on a
// windowed plan: they replace the TPU kernels' composition in
// spgemm_gnn_tpu/kernels/planned.py:233 sspmm_backward (B2 on Aᵀ,
// spgemm_pallas.py:97, the packed branch :124-129, :183-186 for bf16
// messages, out_dtype planned.py:271-274, :300, then B4's channel sampling,
// spgemm_pallas.py:385), behind the port's SAMPLED_BACKWARD rule. The
// cotangent of an aggregation whose input is MaxK's output is needed only
// at the k channels ch[u, .] each row kept: dx[u, ch[u, j]] = post[u] *
// sum_v pre[v] m[v, ch[u, j]], 0 at the row's other channels. Bound on this
// card at Reddit (k 32, dim 256): bytes, each once (m 119.3 MB bf16 or
// 238.6 MB f32, the ids 7.5 MB, Aᵀ's indices 453.2 MB, y 238.6 MB f32 or
// 119.3 MB bf16), 0.244 ms bf16, 0.280 ms f32 (0.209 bf16 out); the 2 E k
// operations take 0.108 ms; the 2k or 4k bytes an edge needs, gathered
// with no reuse, 2.16 or 4.33 ms. The dense forms read a 512-B or 1-KB row
// an edge from L2 (their source blocks keep the slab there) at the rate L2
// serves such rows (8.49 and 15.7 ms) and keep 1/8 of what they add; the
// sampled forms take 6.60 and 9.89 ms on the H100 (PERF.md).
// Design (csr_sspmm_kernel, over the message type): the dense form's
// schedule, passes, fix-up and layers of the sum, at k channels: a warp
// loads its row's ids once a segment, and lane j adds m[v, ch[u, j]] of
// each edge from the L2-resident slab, so a warp load touches the sectors
// of the k channels (about 14 of a bf16 row's 16 at k 32, 21 of an f32
// row's 32) and adds only what is kept. bf16 messages carry pre (round_rows)
// and each term is added, the dense bf16 kernel's FMA by 1; f32 messages
// are the raw cotangent and each term is fmaf(pre[v], m[v, c], .), the
// dense f32 kernel's step. A row's sums stay compact across the block
// passes, in an N x k f32 accumulator (30 MB at Reddit, which L2 holds
// beside the slab) in place of the dense y's 2 GB of pass-to-pass traffic,
// and the dense output row is written once, at the row's last block,
// through a shared-memory row. Each kept channel's sum runs in the dense
// form's order, so it is csr_spmm_bf16's (csr_spmm's) value bit for bit,
// and the bf16 output takes round_out's rule. Two two-pass forms
// (stream_sspmm's 2k-byte slots, written in the schedule's order or in
// A's) lost to the bf16 form on the H100 (6.70 against 10.6 and 11.7 ms,
// PERF.md) and were removed.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarpsPerBlock = 8;
constexpr int kFirst = 1;  // graphs/tiles.py::FIRST
constexpr int kLast = 2;   // graphs/tiles.py::LAST

// rows fetched ahead per warp: 8 at NV <= 2 16-byte slices per lane (dim <=
// 256 in f32, <= 512 in bf16), then about 8 KB per warp
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

// The rows a lane gathers: NV 16-byte slices lane + 32 t of a row, summed
// into kAcc float4 accumulators; accumulator a is float4 pos(a, lane) of the
// f32 output row.
// F32: a slice is 4 channels, one accumulator.
template <int NV>
struct F32 {
  using V = float4;
  static constexpr int kSlices = NV, kAcc = NV;
  __device__ __forceinline__ static int pos(int a, int lane) {
    return lane + 32 * a;
  }
  __device__ __forceinline__ static void fma(float4 (&acc)[kAcc], int t,
                                             float s, const float4& q) {
    fma4(acc[t], s, q);
  }
};

// BF16: a slice is 8 bf16 channels (channel 2i in the low half of word i),
// widened exactly to two float4 accumulators.
template <int NV>
struct BF16 {
  using V = uint4;
  static constexpr int kSlices = NV, kAcc = 2 * NV;
  __device__ __forceinline__ static int pos(int a, int lane) {
    return 2 * (lane + 32 * (a >> 1)) + (a & 1);
  }
  __device__ __forceinline__ static void fma(float4 (&acc)[kAcc], int t,
                                             float s, const uint4& q) {
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
};

// A row's sum over one pass goes to y: written on the row's first block,
// else added to what earlier blocks left; scaled by post on its last block.
// acc[a] is float4 R::pos(a) of the row (dim4 float4s).
template <class R>
__device__ __forceinline__ void store_row(const float4 (&acc)[R::kAcc],
                                          int row, int flags,
                                          const float* __restrict__ post,
                                          float4* __restrict__ y, int dim4,
                                          int lane) {
  float4* yr = y + (int64_t)row * dim4;
  const float p = ((flags & kLast) && post != nullptr) ? post[row] : 1.f;
#pragma unroll
  for (int a = 0; a < R::kAcc; ++a) {
    const int c = R::pos(a, lane);
    if (c < dim4) {
      float4 v = acc[a];
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

// One warp per segment (row, lo, hi, out), rows fetched kAhead ahead into
// registers: a whole run's sum to y, a piece of a split run's to its slot.
// nx: R::V slices per row of x; dim4: float4s per row of y.
template <class R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_segment_kernel(const int4* __restrict__ seg, int64_t n_seg,
                   const int* __restrict__ indices,
                   const typename R::V* __restrict__ x,
                   const float* __restrict__ pre,
                   const float* __restrict__ post, float4* __restrict__ y,
                   float4* __restrict__ scratch, int nx, int dim4) {
  constexpr int NV = R::kSlices;
  constexpr int D = kAhead<NV>;
  using V = typename R::V;
  const int lane = threadIdx.x & 31;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (i >= n_seg) return;  // i is uniform across the warp
  const int4 s = seg[i];

  float4 acc[R::kAcc];
#pragma unroll
  for (int a = 0; a < R::kAcc; ++a) acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
  // a batch's source ids are loaded one batch ahead
  int un = s.y + lane < s.z ? indices[s.y + lane] : 0;
  for (int base = s.y; base < s.z; base += 32) {
    const int u = un;
    un = base + 32 + lane < s.z ? indices[base + 32 + lane] : 0;
    const float sc = (pre != nullptr && base + lane < s.z) ? pre[u] : 1.f;
    const int cnt = min(32, s.z - base);
    float4 part[R::kAcc];  // this batch's sum
#pragma unroll
    for (int a = 0; a < R::kAcc; ++a) part[a] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int j = 0; j < cnt; j += D) {  // D divides 32: j + d < 32
      V q[D][NV];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int ud = __shfl_sync(kFull, u, j + d);
        if (j + d < cnt) {
          const V* xr = x + (int64_t)ud * nx;
#pragma unroll
          for (int t = 0; t < NV; ++t) {
            const int c = lane + 32 * t;
            if (c < nx) q[d][t] = __ldg(xr + c);
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
            if (c < nx) R::fma(part, t, sd, q[d][t]);
          }
        }
      }
    }
#pragma unroll
    for (int a = 0; a < R::kAcc; ++a) add4(acc[a], part[a]);
  }
  if (s.w < 0) {
    store_row<R>(acc, s.x, -1 - s.w, post, y, dim4, lane);
    return;
  }
  float4* out = scratch + (int64_t)s.w * dim4;
#pragma unroll
  for (int a = 0; a < R::kAcc; ++a) {
    const int c = R::pos(a, lane);
    if (c < dim4) out[c] = acc[a];
  }
}

// One warp per split run (row, slot_lo, slot_hi, flags): its pieces' sums in
// order, then to y as a whole segment's. Element by element, so it serves
// either row type: NV float4 slices lane + 32 t per lane.
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
  store_row<F32<NV>>(acc, f.x, f.w, post, y, dim4, lane);
}

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kWarpsPerBlock - 1) / kWarpsPerBlock);
}

// float4 or uint4 slices per lane for n of them per row: ceil(n / 32)
// rounded up to a power of two
int slices(int n) { return n <= 32 ? 1 : n <= 64 ? 2 : n <= 128 ? 4 : 8; }

void launch_fixup(const int4* fix, int64_t n_fix, const float* post,
                  const float4* scratch, float4* y, int dim4,
                  cudaStream_t s) {
  const unsigned blocks = blocks_for(n_fix);
  const int threads = kWarpsPerBlock * 32;
  switch (slices(dim4)) {
    case 1:
      csr_fixup_kernel<1><<<blocks, threads, 0, s>>>(fix, n_fix, post,
                                                     scratch, y, dim4);
      break;
    case 2:
      csr_fixup_kernel<2><<<blocks, threads, 0, s>>>(fix, n_fix, post,
                                                     scratch, y, dim4);
      break;
    case 4:
      csr_fixup_kernel<4><<<blocks, threads, 0, s>>>(fix, n_fix, post,
                                                     scratch, y, dim4);
      break;
    default:
      csr_fixup_kernel<8><<<blocks, threads, 0, s>>>(fix, n_fix, post,
                                                     scratch, y, dim4);
  }
}

// One pass per source block: its segments, then its split runs' fix-ups.
template <class R>
int run(const int4* seg, const int4* fix, const int64_t* pass_seg,
        const int64_t* pass_fix, int nb, const int* indices,
        const typename R::V* x, const float* pre, const float* post,
        float4* y, float4* scratch, int nx, int dim4, cudaStream_t s) {
  for (int b = 0; b < nb; ++b) {
    const int64_t n_seg = pass_seg[b + 1] - pass_seg[b];
    if (n_seg > 0) {
      csr_segment_kernel<R><<<blocks_for(n_seg), kWarpsPerBlock * 32, 0, s>>>(
          seg + pass_seg[b], n_seg, indices, x, pre, post, y, scratch, nx,
          dim4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int64_t n_fix = pass_fix[b + 1] - pass_fix[b];
    if (n_fix > 0) {
      launch_fixup(fix + pass_fix[b], n_fix, post, scratch, y, dim4, s);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// The product over x's row type R; nx: R::V slices per row.
template <template <int> class R>
int dispatch(const void* seg, const void* fix, const void* pass_seg,
             const void* pass_fix, int nb, const void* indices, const void* x,
             const void* pre, const void* post, void* y, void* scratch,
             int nx, int dim4, void* stream) {
  const int4* sp = static_cast<const int4*>(seg);
  const int4* fp = static_cast<const int4*>(fix);
  const int64_t* ps = static_cast<const int64_t*>(pass_seg);
  const int64_t* pf = static_cast<const int64_t*>(pass_fix);
  const int* ix = static_cast<const int*>(indices);
  const float* pp = static_cast<const float*>(pre);
  const float* qp = static_cast<const float*>(post);
  float4* yp = static_cast<float4*>(y);
  float4* sc = static_cast<float4*>(scratch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define RUN(NV_)                                                          \
  run<R<NV_>>(sp, fp, ps, pf, nb, ix,                                     \
              static_cast<const typename R<NV_>::V*>(x), pp, qp, yp, sc, nx, \
              dim4, s)
  switch (slices(nx)) {
    case 1:
      return RUN(1);
    case 2:
      return RUN(2);
    case 4:
      return RUN(4);
    default:
      return RUN(8);
  }
#undef RUN
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously, with the L2 policy
// pol (cp.async.cg: not kept in L1); the helpers of csrc/stream.cu.
__device__ __forceinline__ void cp16(unsigned dst, const void* src,
                                     uint64_t pol) {
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2;"
               :
               : "r"(dst), "l"(src), "l"(pol)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// 4 bytes from global to shared memory, asynchronously, with the L2 policy
// pol (cp.async.ca: the copy that takes a record not aligned to 16 bytes).
__device__ __forceinline__ void cp4(unsigned dst, const void* src,
                                    uint64_t pol) {
  asm volatile("cp.async.ca.shared.global.L2::cache_hint [%0], [%1], 4, %2;"
               :
               : "r"(dst), "l"(src), "l"(pol)
               : "memory");
}

// The record types of csr_cbsr_kernel: a record of words(k) 32-bit words a
// node, copied CB bytes a lane at a time, EPS records a stage, and `add`,
// one edge's record scattered into the warp's f32 partial row `part` (lane
// j takes slot j, then j + 32, ...; the channels of a record are distinct,
// so no two lanes touch one address). A slot whose value is zero adds
// nothing: an f32 sum that starts at +0 never becomes -0, so leaving out
// the FMA of an exact zero keeps its bits. kSharedSum: the kernel keeps an
// entry's sum in the warp's shared memory, not in registers. On the H100
// at Reddit's k 32 that took 160-B f32 records from 8.90 to 8.72 ms (48
// registers, fewer spills, at the same 5 blocks an SM), and 128-B bf16
// ones from 4.18 to 4.50 (the larger ring leaves room for 4 blocks, not 5).
// Bf16Rec: bf16 values, one word a slot (value bits high, channel low), 32
// KV words (KV 128-byte lines); the pre factor is already in the values.
template <int KV>
struct Bf16Rec {
  static constexpr int CB = 16, EPS = KV >= 4 ? 1 : 4 / KV;
  static constexpr bool kPre = false, kSharedSum = false;
  __device__ __forceinline__ static int words(int) { return 32 * KV; }
  __device__ __forceinline__ static void add(const unsigned* sr, float* part,
                                             float, int, int lane) {
#pragma unroll
    for (int t = 0; t < KV; ++t) {
      const unsigned wd = sr[lane + 32 * t];
      const float v = __uint_as_float(wd & 0xffff0000u);
      if (v != 0.f) part[wd & 0xffffu] += v;
    }
  }
};

// F32Rec: f32 values, k value words then ceil(k / 4) words of uint8 ids
// (ops/maxk.py::cbsr_records, 160 B at k 32); slot j adds fmaf(s, v, part[c])
// with s the edge's pre factor, csr_segment_kernel's F32 step. CB is 16 where
// a record is a whole number of 16-byte chunks (k % 16 == 0), else 4.
template <int CB_, int EPS_>
struct F32Rec {
  static constexpr int CB = CB_, EPS = EPS_;
  static constexpr bool kPre = true, kSharedSum = true;
  __device__ __forceinline__ static int words(int k) { return k + (k + 3) / 4; }
  __device__ __forceinline__ static void add(const unsigned* sr, float* part,
                                             float s, int k, int lane) {
    const uint8_t* ids = reinterpret_cast<const uint8_t*>(sr + k);
    for (int j = lane; j < k; j += 32) {
      const float v = __uint_as_float(sr[j]);
      if (v != 0.f) {
        const int c = ids[j];
        part[c] = fmaf(s, v, part[c]);
      }
    }
  }
};

constexpr int kPiece = 4;  // graphs/tiles.py::PIECE

// One warp per entry (out, run_lo, run_hi, flags) of a record pass
// (graphs/tiles.py::RecordWalk), over records of type Rec: the runs
// runs[run_lo:run_hi] in order. A whole run (lo, hi) is summed as a
// segment of csr_spmm's schedule is: batches of 32 edges from lo, each
// scattered edge by edge into the warp's f32 partial row, then added to the
// run's sum. A split run (-1 - slot_lo, slot_hi) is the sum of its pieces'
// scratch slots in order, as csr_fixup_kernel adds them. Each run's sum is
// added to the entry's (from +0 on FIRST, else from what y holds of the
// row's earlier blocks), and the entry's sum written once: to scratch slot
// `out` for a piece (PIECE), else to y[out], times post[out] on LAST. An
// f32 sum from +0 is never -0, so adding the first run's sum to +0 gives its
// bits: y is the per-block passes' left fold bit for bit.
//
// A run's records go through a ring of S stages in the warp's shared
// memory, Rec::EPS records a stage (32 / EPS lanes a record, CB bytes a
// copy, S EPS <= 32 edges ahead), and the ids of a batch of 32 edges (and,
// with pre, their pre factors) are loaded a batch ahead, as csr_spmm's
// segments load them. dim4 <= 64 (dim <= 256): BF16<1>'s two float4 sums a
// lane hold channels 8 lane ... 8 lane + 7. At most 48 registers, for 5
// blocks an SM: unbounded, the walk took 64 and 4 blocks, and the f32 form
// 9.02 ms against 8.89 (H100, Reddit, the entry's sum in registers).
template <class Rec, int S>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, 5)
csr_cbsr_kernel(const int4* __restrict__ entries, int64_t n_entries,
                const int2* __restrict__ runs,
                const int* __restrict__ indices,
                const unsigned* __restrict__ rec,
                const float* __restrict__ pre,
                const float* __restrict__ post, float4* __restrict__ y,
                float4* __restrict__ scratch, int k, int dim4) {
  using R = BF16<1>;
  constexpr int EPS = Rec::EPS;
  constexpr int LPR = 32 / EPS;  // lanes a record
  constexpr int CW = Rec::CB / 4;  // words a copy
  static_assert(S * EPS <= 32 && (S & (S - 1)) == 0, "S stages ahead");
  extern __shared__ float4 cbsr_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n_entries) return;  // i is uniform across the warp
  const int4 w = entries[i];
  const int rw = Rec::words(k);  // words a record
  const int sw = rw * EPS;       // words a stage
  const int rc = rw / CW;        // copies a record
  constexpr int RS = Rec::kSharedSum ? 2 : 1;  // rows: the partial, the sum
  float4* part4 = cbsr_smem + warp * (RS * dim4 + S * sw / 4);
  float* part = reinterpret_cast<float*>(part4);
  float4* shared_sum = part4 + dim4;
  unsigned* ring = reinterpret_cast<unsigned*>(part4 + RS * dim4);
  uint64_t keep;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));

  float4* out = ((w.w & kPiece) ? scratch : y) + (int64_t)w.x * dim4;
  // the entry's sum, float4 c = R::pos(a, lane) of it a lane's own
  float4 sum[R::kAcc];
  auto add_sum = [&](int a, int c, const float4& v) {
    if constexpr (Rec::kSharedSum) {
      float4 t = shared_sum[c];
      add4(t, v);
      shared_sum[c] = t;
    } else {
      add4(sum[a], v);
    }
  };
#pragma unroll
  for (int a = 0; a < R::kAcc; ++a) {
    const int c = R::pos(a, lane);
    const float4 v = (w.w & kFirst) || c >= dim4
                         ? make_float4(0.f, 0.f, 0.f, 0.f)
                         : out[c];
    if constexpr (Rec::kSharedSum) {
      if (c < dim4) shared_sum[c] = v;
    } else {
      sum[a] = v;
    }
  }
  for (int q = lane; q < dim4; q += 32)
    part4[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();

  // run d's first two batches of ids, if it is whole
  auto first_ids = [&](int2 d, int& a, int& b) {
    a = d.x >= 0 && d.x + lane < d.y ? __ldcs(indices + d.x + lane) : 0;
    b = d.x >= 0 && d.x + 32 + lane < d.y ? __ldcs(indices + d.x + 32 + lane)
                                          : 0;
  };
  for (int r = w.y; r < w.z; ++r) {
    const int2 d = runs[r];
    int cu, nu;
    first_ids(d, cu, nu);
    if (d.x < 0) {  // a split run: its slots in order
#pragma unroll
      for (int a = 0; a < R::kAcc; ++a) {
        const int c = R::pos(a, lane);
        if (c < dim4) {
          float4 v = scratch[(int64_t)(-1 - d.x) * dim4 + c];
          for (int q = -d.x; q < d.y; ++q)
            add4(v, scratch[(int64_t)q * dim4 + c]);
          add_sum(a, c, v);
        }
      }
    } else {
      const int lo = d.x, hi = d.y;
      float cs = Rec::kPre && pre != nullptr && lo + lane < hi
                     ? __ldg(pre + cu)
                     : 1.f;
      // stage st (edges lo + EPS st ...) into ring slot st % S; `ids` holds
      // the batch of its edges, its first edge at index i0 there
      auto fetch = [&](int st, int ids, int i0) {
        unsigned* slot = ring + (st % S) * sw;
        const int ri = lane / LPR;  // the lane's record of the stage
        const int u = __shfl_sync(kFull, ids, (i0 + ri) & 31);
        if (lo + EPS * st + ri < hi) {
          for (int q = lane % LPR; q < rc; q += LPR) {
            const unsigned dst = smem_addr(slot + ri * rw + q * CW);
            const unsigned* src = rec + (int64_t)u * rw + q * CW;
            if (Rec::CB == 16)
              cp16(dst, src, keep);
            else
              cp4(dst, src, keep);
          }
        }
        cp_commit();
      };
#pragma unroll
      for (int st = 0; st < S; ++st) fetch(st, cu, EPS * st);
      // edge i0 + e of the batch: its record's slots into the partial row
      auto consume = [&](const unsigned* sr, int e) {
        const float sv = Rec::kPre ? __shfl_sync(kFull, cs, e) : 1.f;
        Rec::add(sr, part, sv, k, lane);
        __syncwarp();
      };
      float4 acc[R::kAcc];  // the run's
#pragma unroll
      for (int a = 0; a < R::kAcc; ++a)
        acc[a] = make_float4(0.f, 0.f, 0.f, 0.f);
      int st = 0;  // the stage at hand: edges lo + EPS st ...
      for (int base = lo; base < hi; base += 32) {
        const int cnt = min(32, hi - base);
        for (int i0 = 0; i0 < cnt; i0 += EPS, ++st) {
          cp_wait<S - 1>();  // stage st has landed (one group a stage)
          __syncwarp();
          const unsigned* sr = ring + (st % S) * sw;
          if (i0 + EPS <= cnt) {
#pragma unroll
            for (int e = 0; e < EPS; ++e) consume(sr + e * rw, i0 + e);
          } else {
            for (int e = 0; e < cnt - i0; ++e) consume(sr + e * rw, i0 + e);
          }
          const int ahead = i0 + EPS * S;
          fetch(st + S, ahead < 32 ? cu : nu, ahead & 31);
        }
        // the batch's sum joins the run's (csr_segment_kernel's layers)
#pragma unroll
        for (int a = 0; a < R::kAcc; ++a) {
          const int c = R::pos(a, lane);
          if (c < dim4) {
            add4(acc[a], part4[c]);
            part4[c] = make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
        __syncwarp();
        cu = nu;
        cs = Rec::kPre && pre != nullptr && base + 32 + lane < hi
                 ? __ldg(pre + cu)
                 : 1.f;
        nu = base + 64 + lane < hi ? __ldcs(indices + base + 64 + lane) : 0;
      }
#pragma unroll
      for (int a = 0; a < R::kAcc; ++a) {
        const int c = R::pos(a, lane);
        if (c < dim4) add_sum(a, c, acc[a]);
      }
    }
  }
  const float p = ((w.w & kLast) && post != nullptr) ? post[w.x] : 1.f;
#pragma unroll
  for (int a = 0; a < R::kAcc; ++a) {
    const int c = R::pos(a, lane);
    if (c < dim4) {
      float4 v = Rec::kSharedSum ? shared_sum[c] : sum[a];
      if (w.w & kLast) v = make_float4(v.x * p, v.y * p, v.z * p, v.w * p);
      out[c] = v;
    }
  }
}

// csr_cbsr_kernel over a record walk: each record pass's pieces, then its
// rows, two launches at most a pass. rw: words a record.
template <class Rec, int S>
int run_cbsr(const int4* entries, const int2* runs, const int64_t* offsets,
             int passes, const int* indices, const unsigned* rec,
             const float* pre, const float* post, float4* y, float4* scratch,
             int k, int rw, int dim4, cudaStream_t s) {
  const size_t smem = (size_t)kWarpsPerBlock *
                      ((Rec::kSharedSum ? 2 : 1) * dim4 * 16 +
                       S * Rec::EPS * rw * 4);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        csr_cbsr_kernel<Rec, S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  for (int l = 0; l < 2 * passes; ++l) {
    const int64_t n = offsets[l + 1] - offsets[l];
    if (n > 0) {
      csr_cbsr_kernel<Rec, S><<<blocks_for(n), kWarpsPerBlock * 32, smem, s>>>(
          entries + offsets[l], n, runs, indices, rec, pre, post, y, scratch,
          k, dim4);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// ---- csr_sspmm: MaxK's backward at the kept channels --------------------

// The message types of csr_sspmm_kernel: a channel of a message row, widened
// to f32 exactly. bf16 messages carry their pre factor (round_rows, or the
// 16-bit model's bf16 product); f32 messages are the raw cotangent, and each
// edge's term takes the pre factor of its source by an FMA, as
// csr_segment_kernel's F32 rows do.
struct Bf16Msg {
  using T = uint16_t;
  static constexpr bool kPre = false;
  __device__ __forceinline__ static float widen(T q) {
    return __uint_as_float((unsigned)q << 16);
  }
};

struct F32Msg {
  using T = float;
  static constexpr bool kPre = true;
  __device__ __forceinline__ static float widen(T q) { return q; }
};

// edges a warp has in flight: KT loads each, 16 a lane
template <int KT>
constexpr int kAheadS = 16 / KT;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// A row's compact sums (lane j holds channel ch[row, j + 32 t] in v[t])
// after a pass, as store_row treats a dense row: written to the compact
// accumulator acc [n_rows, k] on the row's first block, else added to it;
// on its last block the dense output row is written through the warp's
// shared row `buf`: 0 at every channel but the kept ones, which take v *
// post (f32 y) or bf16(bf16(v) * bf16(post)) (bf16 y, round_out's rule).
template <int KT, bool OUT16>
__device__ __forceinline__ void finish_sampled(
    float (&v)[KT], const int (&c)[KT], int row, int flags,
    const float* __restrict__ post, float* __restrict__ acc,
    void* __restrict__ y, float4* __restrict__ buf, int dim, int k,
    int lane) {
  float* ar = acc + (int64_t)row * k;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int j = lane + 32 * t;
    if (j < k && !(flags & kFirst)) v[t] = ar[j] + v[t];
  }
  if (!(flags & kLast)) {
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int j = lane + 32 * t;
      if (j < k) ar[j] = v[t];
    }
    return;
  }
  const int n16 = OUT16 ? dim / 8 : dim / 4;  // 16-byte words of a y row
  for (int q = lane; q < n16; q += 32)
    buf[q] = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  if constexpr (OUT16) {
    const float p = post != nullptr ? bf16_round(post[row]) : 1.f;
    __nv_bfloat16* b16 = reinterpret_cast<__nv_bfloat16*>(buf);
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (lane + 32 * t < k)
        b16[c[t]] = __float2bfloat16_rn(bf16_round(v[t]) * p);
  } else {
    const float p = post != nullptr ? post[row] : 1.f;
    float* b32 = reinterpret_cast<float*>(buf);
#pragma unroll
    for (int t = 0; t < KT; ++t)
      if (lane + 32 * t < k) b32[c[t]] = v[t] * p;
  }
  __syncwarp();
  float4* yr = static_cast<float4*>(y) + (int64_t)row * n16;
  for (int q = lane; q < n16; q += 32) __stcs(yr + q, buf[q]);
}

// One warp per segment (row, lo, hi, out) of csr_spmm's schedule, at the
// row's k kept channels only: lane j sums channel c = ch[row, j] (then j +
// 32, ...) of each edge's source message m[u, c] of type M, batches of 32
// edges from +0 in edge order, each term fmaf(pre[u], m[u, c], ·) for f32
// messages and an add for bf16 ones (the dense kernel's FMA by a pre factor
// of 1), each batch's sum added to the segment's: the dense kernel's sums
// at that channel. The row's ids are loaded once a segment; the source ids
// (and pre factors) a batch ahead, as the dense kernel loads them; kAheadS
// edges' loads in flight a lane. A whole segment finishes its row
// (finish_sampled), a piece of a split run leaves its sums in compact
// scratch slot `out`.
template <class M, int KT, bool OUT16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_sspmm_kernel(const int4* __restrict__ seg, int64_t n_seg,
                 const int* __restrict__ ids,
                 const typename M::T* __restrict__ src,
                 const float* __restrict__ pre,
                 const uint8_t* __restrict__ ch,
                 const float* __restrict__ post, float* __restrict__ acc,
                 float* __restrict__ scratch, void* __restrict__ y, int dim,
                 int k) {
  constexpr int D = kAheadS<KT>;
  using T = typename M::T;
  extern __shared__ float4 sspmm_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n_seg) return;  // i is uniform across the warp
  const int4 s = seg[i];
  int c[KT];
  float v[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int j = lane + 32 * t;
    c[t] = j < k ? ch[(int64_t)s.x * k + j] : 0;
    v[t] = 0.f;
  }
  int un = s.y + lane < s.z ? ids[s.y + lane] : 0;
  for (int base = s.y; base < s.z; base += 32) {
    const int u = un;
    un = base + 32 + lane < s.z ? ids[base + 32 + lane] : 0;
    const float sc =
        M::kPre && pre != nullptr && base + lane < s.z ? pre[u] : 1.f;
    const int cnt = min(32, s.z - base);
    float part[KT];  // this batch's sums
#pragma unroll
    for (int t = 0; t < KT; ++t) part[t] = 0.f;
    for (int jj = 0; jj < cnt; jj += D) {  // D divides 32: jj + d < 32
      T q[D][KT];
#pragma unroll
      for (int d = 0; d < D; ++d) {
        const int64_t r = __shfl_sync(kFull, u, jj + d);
#pragma unroll
        for (int t = 0; t < KT; ++t) {
          const int j = lane + 32 * t;
          q[d][t] = 0;
          if (jj + d < cnt && j < k) q[d][t] = __ldg(src + r * dim + c[t]);
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if (M::kPre) {
          const float sd = __shfl_sync(kFull, sc, jj + d);
          if (jj + d < cnt) {
#pragma unroll
            for (int t = 0; t < KT; ++t)
              part[t] = fmaf(sd, M::widen(q[d][t]), part[t]);
          }
        } else if (jj + d < cnt) {
#pragma unroll
          for (int t = 0; t < KT; ++t) part[t] += M::widen(q[d][t]);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < KT; ++t) v[t] += part[t];
  }
  if (s.w < 0) {
    finish_sampled<KT, OUT16>(v, c, s.x, -1 - s.w, post, acc, y,
                              sspmm_smem + warp * (dim / 4), dim, k, lane);
    return;
  }
  float* out = scratch + (int64_t)s.w * k;
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int j = lane + 32 * t;
    if (j < k) out[j] = v[t];
  }
}

// One warp per split run (row, slot_lo, slot_hi, flags): its pieces'
// compact sums in order, then the row as a whole segment's
// (csr_fixup_kernel on the kept channels).
template <int KT, bool OUT16>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
csr_sspmm_fixup_kernel(const int4* __restrict__ fix, int64_t n_fix,
                       const uint8_t* __restrict__ ch,
                       const float* __restrict__ post,
                       const float* __restrict__ scratch,
                       float* __restrict__ acc, void* __restrict__ y, int dim,
                       int k) {
  extern __shared__ float4 sspmm_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (i >= n_fix) return;  // i is uniform across the warp
  const int4 f = fix[i];
  int c[KT];
  float v[KT];
#pragma unroll
  for (int t = 0; t < KT; ++t) {
    const int j = lane + 32 * t;
    c[t] = j < k ? ch[(int64_t)f.x * k + j] : 0;
    v[t] = j < k ? scratch[(int64_t)f.y * k + j] : 0.f;
  }
  for (int q = f.y + 1; q < f.z; ++q) {
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const int j = lane + 32 * t;
      if (j < k) v[t] += scratch[(int64_t)q * k + j];
    }
  }
  finish_sampled<KT, OUT16>(v, c, f.x, f.w, post, acc, y,
                            sspmm_smem + warp * (dim / 4), dim, k, lane);
}

// csr_sspmm_kernel's passes, as run's: each source block's segments, then
// its split runs' fix-ups.
template <class M, int KT, bool OUT16>
int run_sspmm(const int4* seg, const int4* fix, const int64_t* pass_seg,
              const int64_t* pass_fix, int nb, const int* ids,
              const typename M::T* src, const float* pre, const uint8_t* ch,
              const float* post, float* acc, float* scratch, void* y,
              int dim, int k, cudaStream_t s) {
  const size_t smem = (size_t)kWarpsPerBlock * dim * 4;
  for (int b = 0; b < nb; ++b) {
    const int64_t n_seg = pass_seg[b + 1] - pass_seg[b];
    if (n_seg > 0) {
      csr_sspmm_kernel<M, KT, OUT16>
          <<<blocks_for(n_seg), kWarpsPerBlock * 32, smem, s>>>(
              seg + pass_seg[b], n_seg, ids, src, pre, ch, post, acc, scratch,
              y, dim, k);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
    const int64_t n_fix = pass_fix[b + 1] - pass_fix[b];
    if (n_fix > 0) {
      csr_sspmm_fixup_kernel<KT, OUT16>
          <<<blocks_for(n_fix), kWarpsPerBlock * 32, smem, s>>>(
              fix + pass_fix[b], n_fix, ch, post, scratch, acc, y, dim, k);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return (int)cudaGetLastError();
}

// The sampled product on messages of type M, at KT slots a lane
// (slices(k)); OUT16 only for bf16 messages.
template <class M, bool OUT16>
int sspmm(const void* seg, const void* fix, const void* pass_seg,
          const void* pass_fix, int nb, const void* indices, const void* m,
          const void* pre, const void* ch, const void* post, void* acc,
          void* scratch, void* y, int k, int dim, void* stream) {
#define SSPMM(KT_)                                                          \
  run_sspmm<M, KT_, OUT16>(                                                 \
      static_cast<const int4*>(seg), static_cast<const int4*>(fix),         \
      static_cast<const int64_t*>(pass_seg),                                \
      static_cast<const int64_t*>(pass_fix), nb,                            \
      static_cast<const int*>(indices),                                     \
      static_cast<const typename M::T*>(m), static_cast<const float*>(pre), \
      static_cast<const uint8_t*>(ch), static_cast<const float*>(post),     \
      static_cast<float*>(acc), static_cast<float*>(scratch), y, dim, k,    \
      static_cast<cudaStream_t>(stream))
  switch (slices(k)) {
    case 1:
      return SSPMM(1);
    case 2:
      return SSPMM(2);
    case 4:
      return SSPMM(4);
    default:
      return SSPMM(8);
  }
#undef SSPMM
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
  return dispatch<F32>(seg, fix, pass_seg, pass_fix, nb, indices, x, pre,
                       post, y, scratch, dim / 4, dim / 4, stream);
}

// csr_spmm on x bf16 [n_src, dim] (the rows of round_rows; y, scratch, pre
// and post as in csr_spmm). Needs dim % 8 == 0, dim <= 1024 and 16-byte
// aligned x, y and scratch.
extern "C" int csr_spmm_bf16(const void* seg, const void* fix,
                             const void* pass_seg, const void* pass_fix,
                             int nb, const void* indices, const void* x,
                             const void* pre, const void* post, void* y,
                             void* scratch, int dim, void* stream) {
  if (dim < 8 || dim % 8 != 0 || dim > 1024 || nb < 1)
    return (int)cudaErrorInvalidValue;
  return dispatch<BF16>(seg, fix, pass_seg, pass_fix, nb, indices, x, pre,
                        post, y, scratch, dim / 8, dim / 4, stream);
}

// y <- post * (A cbsr(records)) over a schedule's record walk
// (graphs/tiles.py::RecordWalk: entries int32 [n, 4] and runs int32
// [n_runs, 2] on the device, offsets int64 [2 passes + 1] on the host;
// indices int32 [E], the schedule's), as csr_spmm_bf16 on the densified
// rows at that schedule: records int32 [n_src, 32 ceil(k / 32) rounded up
// to 1, 2, 4 or 8 lines], word j the bf16 bits of value j (pre already
// folded in) in its high half and channel j in its low, zero past k
// (ops/maxk.py::cbsr_records on bf16 values), channels distinct within a
// record; y f32 [n_rows, dim], scratch f32 [n_slots, dim] (or null without
// split runs), post f32 [n_rows] or null. Needs dim % 8 == 0, 8 <= dim <=
// 256, 1 <= k < dim and 16-byte aligned records, y and scratch.
extern "C" int csr_cbsr_spmm_bf16(const void* entries, const void* runs,
                                  const void* offsets, int passes,
                                  const void* indices, const void* records,
                                  const void* post, void* y, void* scratch,
                                  int k, int dim, void* stream) {
  if (dim < 8 || dim % 8 != 0 || dim > 256 || k < 1 || k >= dim ||
      passes < 1)
    return (int)cudaErrorInvalidValue;
#define CBSR16(KV_, S_)                                                   \
  run_cbsr<Bf16Rec<KV_>, S_>(                                              \
      static_cast<const int4*>(entries), static_cast<const int2*>(runs),   \
      static_cast<const int64_t*>(offsets), passes,                        \
      static_cast<const int*>(indices),                                    \
      static_cast<const unsigned*>(records), nullptr,                      \
      static_cast<const float*>(post), static_cast<float4*>(y),            \
      static_cast<float4*>(scratch), k, 32 * KV_, dim / 4,                 \
      static_cast<cudaStream_t>(stream))
  switch (slices(k)) {
    case 1:
      return CBSR16(1, 8);
    case 2:
      return CBSR16(2, 8);
    case 4:
      return CBSR16(4, 8);
    default:
      return CBSR16(8, 4);
  }
#undef CBSR16
}

// y <- post * (A (pre * cbsr(records))) over a schedule's record walk, as
// csr_spmm on the densified rows at that schedule bit for bit: records
// int32 [n_src, k + ceil(k / 4)], k f32 values (their bits) then the uint8
// channel ids packed four to a word (ops/maxk.py::cbsr_records on f32
// values), channels distinct within a record; pre f32 [n_src] or null; the
// walk, y, scratch and post as in csr_cbsr_spmm_bf16. Needs dim % 4 == 0,
// 4 <= dim <= 256, 1 <= k < dim and 16-byte aligned y and scratch (records
// 16-byte aligned where k % 16 == 0).
extern "C" int csr_cbsr_spmm(const void* entries, const void* runs,
                             const void* offsets, int passes,
                             const void* indices, const void* records,
                             const void* pre, const void* post, void* y,
                             void* scratch, int k, int dim, void* stream) {
  if (dim < 4 || dim % 4 != 0 || dim > 256 || k < 1 || k >= dim ||
      passes < 1)
    return (int)cudaErrorInvalidValue;
  const int rw = k + (k + 3) / 4;
  const bool wide = rw % 4 == 0;  // 16-byte copies
  // two records a stage where 16 lanes copy one, 8 stages (16 edges) in
  // flight: the 160-B records at k 32 took 5.07 ms to gather over Reddit's
  // schedule at 8 stages, 6.14 at 16 (utils/csr_sweep.py --probes, PERF.md)
  const bool two = (wide ? rw / 4 : rw) <= 16;
#define CBSR32(CB_, EPS_)                                                 \
  run_cbsr<F32Rec<CB_, EPS_>, 8>(                                          \
      static_cast<const int4*>(entries), static_cast<const int2*>(runs),   \
      static_cast<const int64_t*>(offsets), passes,                        \
      static_cast<const int*>(indices),                                    \
      static_cast<const unsigned*>(records), static_cast<const float*>(pre), \
      static_cast<const float*>(post), static_cast<float4*>(y),            \
      static_cast<float4*>(scratch), k, rw, dim / 4,                       \
      static_cast<cudaStream_t>(stream))
  if (wide) return two ? CBSR32(16, 2) : CBSR32(16, 1);
  return two ? CBSR32(4, 2) : CBSR32(4, 1);
#undef CBSR32
}

// dx <- MaxK's backward product at its kept channels, over csr_spmm's
// schedule of Aᵀ (seg, fix, pass_seg, pass_fix, nb, indices as in
// csr_spmm): y[r, ch[r, j]] = post[r] * sum over r's edges of m[u, ch[r,
// j]], csr_spmm_bf16's value there bit for bit, and 0 at r's other
// channels. m bf16 [n_src, dim] (the messages, pre folded in), ch uint8
// [n_rows, k] (distinct within a row), post f32 [n_rows] or null; acc f32
// [n_rows, k] and scratch f32 [n_slots, k] (null without split runs) are
// the compact sums; y f32 [n_rows, dim], or with out16 bf16(bf16(sum) *
// bf16(post)). Needs dim % 8 == 0, 8 <= dim <= 256, 1 <= k < dim and a
// 16-byte aligned y.
extern "C" int csr_sspmm_bf16(const void* seg, const void* fix,
                              const void* pass_seg, const void* pass_fix,
                              int nb, const void* indices, const void* m,
                              const void* ch, const void* post, void* acc,
                              void* scratch, void* y, int k, int dim,
                              int out16, void* stream) {
  if (dim < 8 || dim % 8 != 0 || dim > 256 || k < 1 || k >= dim || nb < 1)
    return (int)cudaErrorInvalidValue;
  return out16 ? sspmm<Bf16Msg, true>(seg, fix, pass_seg, pass_fix, nb,
                                      indices, m, nullptr, ch, post, acc,
                                      scratch, y, k, dim, stream)
               : sspmm<Bf16Msg, false>(seg, fix, pass_seg, pass_fix, nb,
                                       indices, m, nullptr, ch, post, acc,
                                       scratch, y, k, dim, stream);
}

// csr_sspmm_bf16 on f32 messages: y[r, ch[r, j]] = post[r] * sum over r's
// edges of pre[u] * m[u, ch[r, j]], csr_spmm's value there bit for bit, 0
// at r's other channels; m f32 [n_src, dim] (the cotangent), pre f32
// [n_src] or null, y f32 [n_rows, dim]; the rest as in csr_sspmm_bf16.
// Needs dim % 4 == 0, 4 <= dim <= 256, 1 <= k < dim and a 16-byte aligned
// y.
extern "C" int csr_sspmm(const void* seg, const void* fix,
                         const void* pass_seg, const void* pass_fix, int nb,
                         const void* indices, const void* m, const void* pre,
                         const void* ch, const void* post, void* acc,
                         void* scratch, void* y, int k, int dim,
                         void* stream) {
  if (dim < 4 || dim % 4 != 0 || dim > 256 || k < 1 || k >= dim || nb < 1)
    return (int)cudaErrorInvalidValue;
  return sspmm<F32Msg, false>(seg, fix, pass_seg, pass_fix, nb, indices, m,
                              pre, ch, post, acc, scratch, y, k, dim, stream);
}
