#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (spgemm_gnn_tpu_torch) on one GPU.

    python3 chip_smoke.py            # from the repository root, on an H100

Phases, each of which raises (exit code != 0, no result line) on failure:
  1. device: a CUDA device must exist; prints the card's name and power limit;
  2. build: compiles every CUDA kernel of the port (nvcc, sm_90a, one nvcc per
     source, all started together);
  3. graph: the synthetic Reddit stand-in at full width (602 features,
     41 classes, N = 232,965, E about 113.3M); the plan rule must pick the
     "windowed" kind (csr_spmm);
  4. kernels: each kernel of the Reddit path at its shapes against its plain
     PyTorch version (MaxK forward/backward bitwise, on random rows with
     integer, zero and utils/rows.py's family rows seeded in; the CSR
     product within
     1e-5 of the largest output magnitude of a float64 run of the plain
     version, and bitwise equal across two runs), timed with CUDA events
     beside its plain version, a PyTorch library call computing the same
     function, and the least time the card could take (bytes over 3.35 TB/s
     or operations over 67 TFLOP/s f32, H100 SXM peaks at 700 W); for
     csr_spmm also its schedule (source blocks, segment size, segments,
     split runs, bytes beyond the CSR) and the same product with one source
     block (the row split alone, also within 1e-5), timed; the stream kernel
     on the same graph, checked the same way (it only measures: the rule
     keeps Reddit on csr_spmm); then the 16-bit stream's form of the
     product, csr_spmm_bf16, on A and Aᵀ: the messages round_rows(x, pre),
     within 1e-5 of max |y| of the plain version in float64 on the same bf16
     rows, bitwise equal across two runs, on fewer source blocks than the
     f32 rows take, timed beside its f32 form, its plain version, its bound,
     the no-reuse gather of 2-byte rows and torch.sparse.mm on a bf16 CSR
     tensor (or "none" and its error where the card's PyTorch refuses it);
     then the 16-bit model's forms: maxk_fwd_bf16 and maxk_bwd_bf16 on
     bf16 rows, bitwise against their plain versions, and
     csr_spmm_bf16_out on A and Aᵀ (bf16 rows pre ⊙ x in, bf16 out),
     bitwise equal to bf16(bf16(y) · bf16(post)) of the same kernel's
     f32-output run and across two runs, and within 1 bf16 ulp of its
     plain version (1e-5 of max |y| where a sum cancels) with at most
     0.5 % of the values off, each timed beside
     its f32 form, its plain version and its bound; then B2's CBSR forms,
     csr_cbsr_spmm_bf16 and csr_cbsr_spmm_bf16_out, on the records of the
     same k-sparse x (cbsr_compact, the values in bf16) at the dense bf16
     form's schedule: bitwise equal to csr_spmm_bf16 / _bf16_out on the
     densified rows, across two runs and to their plain version on
     integer values (exact sums), the f32 output within 1e-5 of max |y|
     of float64, the bf16 output the rounding of the f32 one and within 1
     bf16 ulp of its plain version; timed
     beside the dense form, the plain version, torch.sparse.mm bf16, the
     bound on the 96 B a record needs and its no-reuse gather (the 128-B
     layout's on a line of its own); then B2's sampled forms (MaxK's
     backward on Aᵀ): maxk_fwd and maxk_fwd_bf16 with their kept
     channels' ids at Reddit's shape (timed with and without), then
     csr_sspmm_bf16 and csr_sspmm_bf16_out on Aᵀ at those channels under
     the mean and gcn factors: bitwise equal to csr_spmm_bf16 / _bf16_out
     at the kept channels and 0 elsewhere, across two runs and to their
     plain version on integer messages, within 1e-5 of max |y| (f32 out)
     or 1 bf16 ulp of the plain version (under the gcn factors the bf16
     output bitwise the rounding of the f32 form's sums times
     bf16(post)); timed beside the dense form and maxk_bwd after it, the
     plain version, the bound, the no-reuse gathers and torch.sparse.mm
     then torch.gather;
  5. train: the Reddit recipe (SAGE, MaxK k=32, hidden 256, 4 layers,
     LayerNorm, dropout 0.5, lr 0.01): its first two train steps through the
     kernels within 1e-4 relative of the plain path's (same weights and
     dropout seed), then `Trainer` for 5 epochs; the losses must be finite
     and fall, and every kernel's launch count must match the model's
     structure exactly; then the same with `--stream bf16x2`: its first two
     steps within 1e-4 relative of the same planned path through the plain
     versions (both round the same messages), 5 epochs with finite losses
     and exact launch counts (round_rows, cbsr_compact and
     csr_cbsr_spmm_bf16 on the MaxK forwards at the default rules,
     csr_sspmm_bf16 on the MaxK backwards, no f32 aggregation launch),
     then 5 epochs with STREAM_CBSR_FORWARD off (csr_spmm_bf16 forward),
     the default's losses within 1e-6 relative of theirs (bit-equal at the
     same schedule), and 5 with SAMPLED_BACKWARD off (csr_spmm_bf16 on
     Aᵀ), the default's losses bit-equal to theirs, the steady epochs and
     peak memory of the three runs on one line; then with `--dtype
     bfloat16` (first steps within 1e-3 relative of the plain versions,
     exact counts of the 16-bit forms only: cbsr_compact_bf16 and
     csr_cbsr_spmm_bf16_out forward and csr_sspmm_bf16_out backward at the
     default, no round_rows, falling losses), the three runs as for
     bf16x2;
 5a. mesh (`--mesh_shape 4` in one process, all shards on the card): the
     Reddit graph partitioned into 4 shards (parallel/planned_sharded.py):
     the host build stored to a temporary plan cache (its seconds, nps,
     each role's kind, the round sizes, the boundary rows, comm_stats at
     dim 256 and k 32 in f32 and with the bf16 halo against the full
     gather); each role's per-shard product through its kernel, f32 and
     bf16x2 messages, within 1e-5 of max |y| of its plain version in
     float64, bitwise across two runs, timed; `sharded_planned_aggregate`
     forward and input gradient with the dense and the CBSR exchange
     within 1e-5 (the bf16 halo and the bf16x2 stream within 3e-2) of
     max |y| of the float64 plain product, beside the single-device
     `planned_aggregate`; `run_sweep(4)` (all eight configs); the Trainer
     at `--mesh_shape 4` through the cached build: f32 with dropout 0 for
     3 epochs (the first loss within 1e-4 relative of the single-device
     run's from the same weights, each later difference printed), the
     recipe (dropout 0.5, 5 epochs) with exact launch counts, its steady
     epoch and peak memory beside the single-device run's of phase 5, and
     `--dtype bfloat16` (5 epochs, exact counts, finite falling
     losses); the recipe with `--steps_per_call 4` and evaluations every
     5 epochs (a CUDA graph of the sharded step, replayed 4 times), its
     losses and final weights bit-equal to the same run at steps_per_call
     1, both runs' launches (captured once x replays + eager) exactly the
     mesh's count; `run_trajectory_match(4)` with its checkpoint restore;
     each recipe run's peak memory beside what was resident at its start,
     the smoke's own sharded graph freed before the Trainers run; the
     phase's wall time;
 5c. ranks (after 5a, before 5b): the Reddit recipe over 2 processes on
     the one card, one graph shard a rank (parallel/multihost.py; gloo,
     each collective staged through pinned host memory). The stand-in is
     written once as an npz; then two `chip_smoke.py --rank R` processes
     each start the process group at a free localhost port, print their
     process_summary (backend, device), check their block of
     `sharded_planned_aggregate` (sum; dense, CBSR, CBSR with a bf16 halo;
     a seeded integer-valued k-sparse input) and dx bit for bit against
     the in-process mesh of 2 on the same card, each form's forward and
     exchange timed, its bytes beside comm_stats; then train the recipe
     through the CLI's main (`--multihost --coordinator 127.0.0.1:PORT
     --num_processes 2 --process_id R --mesh_shape 2 --data_path DIR`,
     shard 0 storing the sharded build, shard 1 loading it) 3 epochs in
     f32 and in bfloat16: finite losses, equal on both ranks, exact
     launches a rank (on the kernels line), steady epoch, peak memory,
     the exchange's ms and bytes a layer and the gradient all-reduce's.
     The script then trains the in-process mesh of 2 on the same npz: the
     ranks' first f32 loss within 1e-5 relative of its, the steady epochs
     beside each other and one device's. NCCL is not run (one GPU);
 5b. timing and benches, on the Reddit graph: the aggregation share of a
     train step (utils/timing.py: step_s, aggregation_s, aggregation_pct)
     at f32 and `--dtype bfloat16`; 5 epochs of the bfloat16 recipe with
     `--steps_per_call 4` and evaluations every 5 epochs (a CUDA graph of
     the step, replayed 4 times), its losses and final weights bit-equal to
     the same run at steps_per_call 1 and its launches, captured once x
     replays + eager, equal to that run's (this run stays out of the
     kernels line's counts), both steady epochs printed; the bench harness
     at `--scale medium` (29,121 nodes, E about 13.7M, dim 256, k 32):
     validate_numerics passing, the ELL baseline within 1e-5 of max |y| of
     a float64 plain sum, bench_aggregation with torch, ell and cuda (the
     baselines on a 6M-edge cut graph); then `python -m
     spgemm_gnn_tpu_torch.bench --scale medium` in a subprocess, its one
     JSON line parsed (with the copy and gather rates it measures); each
     line beside the card's name and power limit;
  6. model check: on a small graph (3000 nodes, 2 layers, ReLU, so only the
     aggregation kernel), every model family (SAGE, GCN, GIN, GNNRes and the
     three integrated MaxK models) through the kernels against the same
     model through the plain versions on the same card, on a windowed plan
     and on a stream plan; then each family with MaxK on the stream plan,
     STREAM_CBSR_FORWARD at its default (None: the rule takes
     stream_cbsr_spmm at hidden 256) against off, logits and input gradient
     equal by value;
  7. graph 2: the synthetic ogbn-products stand-in at full size (N =
     2,449,029, E about 123.7M, 100 features, 47 classes); the plan rule must
     pick the "stream" kind (stream_spmm);
 7a. host graph core: the native library (graphs/native.py, g++) must be
     built; the products stand-in's edges in a seeded random order (as an
     npz delivers them) through `from_edges` with the native sort and with
     numpy's, every array bitwise equal to the other's and the stand-in's,
     both times printed;
  8. kernels on products: stream_spmm on A and Aᵀ, and csr_spmm on A, checked
     as in phase 4 (the rule must give csr_spmm one source block here); MaxK
     forward and backward, f32 and bf16, as in phase 4 at the products
     shape (their products_ keys on the kernels line); then
     stream_cbsr_spmm (the CBSR edge-gather forward, on one record per node)
     on A at dim 256, k 32, under the mean and the gcn factors: within 1e-5
     of the plain version in float64, equal by value to stream_spmm on the
     same masked input, bitwise equal across two runs, and timed beside
     stream_spmm, its plain version, torch.sparse.mm on the dense input, and
     cbsr_compact + cbsr_records with it. Each stream kernel (and stream_spmm
     on Reddit in phase 4) also runs with no hot set (budget 0): bitwise
     equal to the default run, and timed, so that the hot set's share of
     the time is on record. The 16-bit forms: stream_spmm_bf16 on A and Aᵀ
     as csr_spmm_bf16 in phase 4 (also with no hot set, bitwise equal);
     round_rows at [N, 256] with a node factor, bitwise equal to its plain
     version and timed; stream_cbsr_spmm_bf16 on 128-B records (the values
     rounded after the pre factor) under the mean and gcn factors, within
     1e-5 of float64, equal by value to stream_spmm_bf16 on the same masked
     input, bitwise equal across runs and with no hot set, timed; the
     bf16-output forms stream_spmm_bf16_out (A, Aᵀ) and
     stream_cbsr_spmm_bf16_out (mean and gcn factors), each bitwise equal
     to the rounding of its f32-output run, across two runs and with no hot
     set (B8 also bitwise equal to B3), within 1 bf16 ulp of its plain
     version (1e-5 of max |y| where a sum cancels) with at most 0.5 % of
     the values off, timed; for both B8 bf16 forms the diagnosis of their
     kernel (SASS instructions and loops, registers, resident warps, and
     two timing variants: the walk and the scatter, the walk and the
     gather); then the sampled backward (B3's 16-bit forms on MaxK's
     backward): maxk_fwd and maxk_fwd_bf16 with their kept channels' ids
     (y and meta those of the form without, ids those of the plain
     version, on seeded rows that keep zeros; timed with and without),
     then stream_sspmm_bf16 and stream_sspmm_bf16_out on Aᵀ at those
     channels under the mean and gcn factors: bitwise equal to
     stream_spmm_bf16 / _bf16_out at the kept channels and 0 elsewhere,
     across two runs and to the k-channel gather probe, within 1e-5 of
     max |y| (f32 out) or 1 bf16 ulp of the plain version (under the gcn
     factors the bf16 output bitwise the rounding of the f32 form's sums
     times bf16(post), and those sums' rounding within 1 ulp); timed with each
     pass alone, beside the dense form and maxk_bwd after it, the gather
     probe, the plain version, the bound, the no-reuse gathers and
     torch.sparse.mm then torch.gather;
  9. CBSR: cbsr_compact, cbsr_densify and cbsr_sample at the products shapes
     (dim 256, k 32), bitwise against their plain versions and timed; then
     `aggregate_cbsr` forward and backward through the kernels, with its
     launches counted, against the dense path, with STREAM_CBSR_FORWARD
     off and then at its default (no densify in the forward);
     cbsr_compact_bf16
     bitwise against its plain version (also on the bf16 MaxK of the family
     rows), and the bf16 LayerNorm kernels
     (layer_norm16_fwd / _bwd) within 1 bf16 ulp of theirs, timed; then
     B4-B6 on bf16: cbsr_densify_bf16, cbsr_densify_bf16_f32,
     cbsr_densify_f32_bf16 (also against torch's cast of the f32 densify:
     round to nearest even) and cbsr_sample_bf16, bitwise against their
     plain versions, timed beside their f32 form, plain version, bound and
     `scatter_` into zeros of the output dtype / `torch.gather`; and the
     bf16 CBSR path (compact on bf16 rows -> aggregate_cbsr forward and
     backward, exact launch counts, y within 1e-5 of max |y| of the dense
     plain path, dvalues within 1 bf16 ulp, dx bitwise the densify of
     dvalues);
 10. train 2: the products recipe (SAGE, MaxK k=32, hidden 256, 3 layers,
     LayerNorm, dropout 0.5, lr 0.003): its first two train steps through the
     kernels within 1e-4 relative of the plain path's (same weights and
     dropout seed), then 5 epochs with finite losses and exact launch counts
     at the default (STREAM_CBSR_FORWARD None: the MaxK forward takes
     stream_cbsr_spmm); then 5 epochs more with the flag off (the dense
     forward), the default's losses within 1e-6 relative of theirs; then
     both runs again with `--stream bf16x2` (first steps against the plain
     versions with the same stream, exact launch counts of round_rows and
     the bf16 kernels: at the default the MaxK backwards on
     stream_sspmm_bf16 and stream_spmm_bf16 not at all; the default
     within 1e-6 relative of flag-off), and a third with SAMPLED_BACKWARD
     off (stream_spmm_bf16 on Aᵀ), the default's losses bit-equal to it;
     then the three runs with `--dtype bfloat16` (first steps within 1e-3
     of the plain versions, exact counts of the 16-bit forms, falling
     losses, the default within 1e-6 of flag-off and bit-equal to
     SAMPLED_BACKWARD off); each line of steady epochs beside the peak
     memory of the three runs;
 11. train 3: the products recipe with GCN and self-loops (`--model gcn
     --selfloop`) at the default rule: its first two train steps
     within 1e-4 relative of the plain path's, then 5 epochs with finite
     losses and exact launch counts (stream_cbsr_spmm forward, stream_spmm
     backward); then the same with `--dtype bfloat16` (both node factors in
     bf16, the bf16-output forms, stream_sspmm_bf16_out on the backwards),
     and again with SAMPLED_BACKWARD off, the losses bit-equal;
 12. serve: the products recipe (f32) checkpointed every 2 epochs of a
     4-epoch run, then a fresh Trainer resumed to 6 epochs: it must start
     at epoch 4 and give the losses of an uninterrupted 6-epoch run bitwise
     (the checkpoint carries the dropout generator); `evaluate_checkpoint`
     of `best` (what `--evaluate` runs) must equal that epoch's record;
     then predict requests of 1, 64 and 1024 test nodes (a seeded draw)
     through the device feature store and host stores of each policy at
     cache ratio 0.05: the logits within 1e-4 of max |logit| of the
     full-graph eval forward at the restored weights (the stream plan's
     kernels, B8 forward at the default) but on rows MaxK near-ties flip
     (at most 0.5 % of the seeds, argmax agreement on 99.5 %), every
     store's logits equal, exact launch
     counts (maxk_fwd and csr_spmm once per layer, no stream_spmm); each
     request's closure per hop, host k-hop, schedule build, fetch (hit rate,
     host-to-device bytes), device forward and wall time are printed;
 12a. remat: the products recipe (f32 SAGE) 3 epochs without and with
     `--remat`: losses and final weights bit-equal, exact launch counts
     (MaxK's forward rerun once a layer a step, no aggregation rerun), peak
     memory lower with it, both steady epochs and peaks printed;
 12b. plan cache: products' plans (f32 and bf16 rows) built with no
     cache, built and stored, then loaded from a temporary directory: every
     plan tensor equal, the aggregation forward and backward on the loaded
     plans bitwise the built ones', the three times printed;
 12c. device inputs: the Reddit stand-in built without its payload (host
     time beside phase 3's), `--device_inputs` for 3 epochs with finite
     losses and exact launch counts; its plans through the cache as in 12b;
     and the Reddit bfloat16 recipe with `--remat --steps_per_call 4`,
     which must raise the documented NotImplementedError;
 12d. proteins: the ogbn-proteins stand-in (N 132,534, E about 79.1M, 8
     features, 112 classes; the windowed kind) on its recipe (SAGE, MaxK
     k=32, 3 x 256, LayerNorm, dropout 0.5, lr 0.01), 5 epochs in f32 and
     with `--dtype bfloat16`, finite losses and exact launch counts (its
     launches also on the kernels line, `proteins_launches`); the f32
     run's train / val / test ROC-AUC on the card within 1e-6 of the
     host `rocauc` on the same logits, the on-card evaluation timed;
 13. accuracy: the reference's 80-epoch trajectory gate (TRAJ_r03.json's
     config: the Reddit stand-in at scale 0.02, SAGE MaxK k=32, 3 x 256,
     LayerNorm, dropout 0, seed 97) through the port's Trainer with the f32
     and the bf16x2 stream and with `--dtype bfloat16`: each best test
     accuracy within 0.03 of the JAX oracle's from the same initial weights
     in its dtype (scripts/port_accuracy_oracle.py: ACC_ORACLE f32,
     ACC_ORACLE16 bf16), and each 16-bit run within 0.03 of f32.
The script's wall time is printed before the {"kernels": [...]} line, and
the card's name and power limit after it; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import collections
import dataclasses
import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

PEAK_BYTES_S = 3.35e12    # H100 SXM HBM3
PEAK_F32_FLOP_S = 67e12   # H100 SXM f32 outside the tensor cores
# the stand-ins at full size, the recipes' epochs, and the seed of the
# graphs, the inputs and the weights
SCALE = 1.0
EPOCHS = 5
SEED = 97
HIDDEN, K = 256, 32
HUB_ROWS = 1024   # 128 blocks of 8 warps: one wave on the H100's 132 SMs
# the accuracy check: TRAJ_r03.json's config; the best test accuracy the
# JAX package's CPU oracle reaches from the initial weights the port's
# Trainer draws at seed 97 (scripts/port_accuracy_oracle.py: 0.8873; 0.8573
# from the JAX package's own draw, 0.849 in TRAJ_r03.json), held within the
# tolerance TRAJ_r03's cross-seed spread (0.0226) grounds
ACC_SCALE, ACC_EPOCHS = 0.02, 80
ACC_ORACLE, ACC_TOL = 0.8873, 0.03
ACC_TRAJ_R03 = 0.849
# the same oracle with `--dtype bfloat16` (flax dtype=bfloat16, impl
# "pallas" in interpret mode: scripts/port_accuracy_oracle.py --dtype
# bfloat16 --starts port, CPU; its JSON line, best_test_accuracy
# 0.8766094446182251 at best_epoch 61, stands verbatim in PERF.md §6)
ACC_ORACLE16 = 0.8766
# the 16-bit model's first two steps, kernels against plain versions: the
# same bf16 roundings but where the f32 sums of two summation orders
# straddle a bf16 rounding boundary (one bf16 ulp is 2^-8 to 2^-7 relative)
STEP_TOL16 = 1e-3
# a bf16-output aggregation against its plain version: the same bf16 values
# summed in f32 in another order, rounded once to bf16 (then by bf16 post),
# so within one bf16 ulp (2^-7 of the plain value's power of two) with at
# most 0.5 % of the values off (tests/test_torch_dtype16.py::near16), but
# where a row's sum cancels to near 0, an ulp of it lies far below the f32
# ordering error of its terms: there, within the f32 checks' 1e-5 of max |y|
AGG_ULPS, AGG_ABS, AGG_SHARE = 1, 1e-5, 0.005
# near16's results under their kernels-line names
NEAR_KEYS = {"ulps": "plain_ulps", "abs_off": "plain_abs_off",
             "off": "plain_share_off"}


def log(msg: str) -> None:
    print(msg, flush=True)


def bound_ms(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / PEAK_BYTES_S * 1e3
    t_ops = n_ops / PEAK_F32_FLOP_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_record_bytes(k: int) -> int:
    """The bytes one node's record of k bf16 values must carry at dim <= 256:
    the values and one byte of channel each, the ids in 32-bit words (96 B at
    k 32, the reference's record). The kernel's record (one 32-bit word a
    slot, padded to 128-B lines: ops/maxk.py::cbsr_records) moves more; that
    layout's traffic is reported beside the bound, not in it."""
    return 2 * k + 4 * -(-k // 4)


def time_ms(torch, fn, iters: int, warmup: int = 1) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bits_equal(torch, a, b) -> bool:
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return bool(torch.equal(a, b))


def rel_err(a, b) -> tuple[float, float]:
    """(max |a - b|, that over max |b|)."""
    err = float((a - b).abs().max())
    return err, err / max(float(b.abs().max()), 1e-30)


def sparse_input(torch, n: int, dim: int, k: int, gen):
    """MaxK of random rows, then dropout 0.5: the aggregation's input on the
    training path (k-sparse, some rows shorter)."""
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
    x = torch.randn((n, dim), generator=gen, device="cuda")
    y, _ = maxk_fwd(x, k)
    keep = torch.rand((n, dim), generator=gen, device="cuda") >= 0.5
    return torch.where(keep, y / 0.5, torch.zeros_like(y))


def hub_rows(torch, indptr, indices, rows: int):
    """The CSR (indptr, indices) of only the `rows` rows of highest degree:
    timed alone, it shows how much of the product the longest rows take by
    themselves."""
    deg = indptr.diff()
    top = torch.topk(deg, min(rows, deg.numel())).indices
    d = deg[top].long()
    sub_indptr = torch.zeros(d.numel() + 1, dtype=torch.long,
                             device=indptr.device)
    torch.cumsum(d, 0, out=sub_indptr[1:])
    total = int(sub_indptr[-1])
    offset = torch.repeat_interleave(indptr[top].long() - sub_indptr[:-1], d,
                                     output_size=total)
    pos = torch.arange(total, device=indptr.device) + offset
    return sub_indptr.int(), indices[pos].contiguous()


def product_check(torch, kernel: str, g, inp, pre_f, post_f,
                  transpose: bool = False) -> dict:
    """Check and time one use of an aggregation kernel ("csr_spmm" or
    "stream_spmm") on the graph's CSR (or its transpose). The reference is
    the plain version in float64, so that the error read is the kernel's own;
    two runs must give the same bits. Also times the kernel on the HUB_ROWS
    rows of highest degree alone (for csr_spmm under the product's number of
    source blocks), the plain version, and `torch.sparse.mm` on a CSR tensor
    of the same weights."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
    from spgemm_gnn_tpu_torch.kernels.stream import stream_spmm, stream_spmm_at
    from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain
    from spgemm_gnn_tpu_torch.ops.stream import stream_spmm_plain

    indptr = g.t_indptr if transpose else g.indptr
    indices = g.t_indices if transpose else g.indices
    rows = g.t_edge_dst if transpose else g.edge_dst
    n, e, dim = g.num_nodes, g.num_edges, inp.shape[1]
    if kernel == "stream_spmm":
        plan = build_stream_plan(indptr, indices)
        hub_ip, hub_ix = hub_rows(torch, indptr, indices, HUB_ROWS)
        hub_plan = build_stream_plan(hub_ip, hub_ix)
        hub_edges = hub_ix.numel()
        plan_bytes = (plan.num_chunks + plan.carry_rows.numel()) * 4

        def run(x):
            return stream_spmm(plan, x, pre_f, post_f)

        def run_plain(x):
            return stream_spmm_plain(plan, x, pre_f, post_f)

        def run_hub():
            return stream_spmm(hub_plan, inp)
    else:
        plan = CSRPlan(indptr, indices)
        hub_plan = CSRPlan(*hub_rows(torch, indptr, indices, HUB_ROWS),
                           src_blocks=plan.schedule(n, dim).nb)
        hub_edges = hub_plan.indices.numel()
        plan_bytes = 0

        def run(x, p=plan):
            return csr_spmm(p, x, pre_f, post_f)

        def run_plain(x):
            return csr_spmm_plain(indptr, indices, x, pre_f, post_f)

        def run_hub():
            return csr_spmm(hub_plan, inp)

    ref = run_plain(inp.double())
    got, again = run(inp), run(inp)
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    if not rel <= 1e-5:
        raise AssertionError(f"{kernel} error {rel:.3e} of max |y| > 1e-5")
    if not bits_equal(torch, got, again):
        raise AssertionError(f"{kernel}: two runs differ")
    extra = {}
    if kernel == "stream_spmm":
        # the same product with no hot set: the same bits, and its time
        def run_hot0():
            return stream_spmm_at(plan, inp, pre_f, post_f, hot_budget=0)
        if not bits_equal(torch, got, run_hot0()):
            raise AssertionError("stream_spmm: hot budget 0 differs from the "
                                 "default")
        extra = hot_keys(plan.hot_set(4 * dim))
        extra["hot0_ms"] = time_ms(torch, run_hot0, 5)
    if kernel == "csr_spmm":
        # the same product with one source block (the row split alone)
        one = CSRPlan(indptr, indices, src_blocks=1)
        single = run(inp, p=one)
        torch.cuda.synchronize()
        single_rel = rel_err(single, ref)[1]
        if not single_rel <= 1e-5:
            raise AssertionError(f"csr_spmm, one block: error "
                                 f"{single_rel:.3e} of max |y| > 1e-5")
        del single
        sched = plan.schedule(n, dim)
        extra = dict(
            nb=sched.nb, block_rows=sched.block_rows, segment=sched.segment,
            segments=sched.num_segments, split_runs=sched.num_split_runs,
            slots=sched.n_slots, plan_extra_bytes=sched.extra_bytes(indices),
            nb1_rel=single_rel,
            nb1_ms=time_ms(torch, lambda: run(inp, p=one), 5))
    w = torch.ones(e, device=inp.device)
    if pre_f is not None:
        w = w * pre_f[indices.long()]
    if post_f is not None:
        w = w * post_f[rows.long()]
    a = torch.sparse_csr_tensor(indptr, indices, w, size=(n, n))
    lib_rel = rel_err(torch.sparse.mm(a, inp), ref)[1]
    del ref, again
    # the products this input needs: a multiply-add per nonzero of each
    # gathered row
    gathered = torch.bincount(indices, minlength=n).double()
    ops = 2.0 * float(((inp != 0).sum(1).double() * gathered).sum())
    n_bytes = (2 * n * dim * 4 + (n + 1) * 4 + e * 4 + plan_bytes
               + 4 * n * ((pre_f is not None) + (post_f is not None)))
    b_ms, b_by = bound_ms(n_bytes, ops)
    ms = time_ms(torch, lambda: run(inp), 5)
    hub_ms = time_ms(torch, run_hub, 5)
    return dict(err=err, rel=rel, bound_ms=b_ms, bound_by=b_by, ms=ms,
                plain_ms=time_ms(torch, lambda: run_plain(inp), 2),
                library_ms=time_ms(torch, lambda: torch.sparse.mm(a, inp), 5),
                library_rel=lib_rel, hub_ms=hub_ms,
                hub_edge_share=hub_edges / e,
                gather_ms=e * dim * 4 / PEAK_BYTES_S * 1e3, **extra)


HOT_KEYS = ("hot_rows", "hot_edge_share", "hot_budget_bytes", "hot0_ms")


def hot_keys(hot) -> dict:
    """A stream kernel's hot set, for its log line and kernels-line entry."""
    return dict(hot_rows=hot.rows, hot_edge_share=hot.edge_share,
                hot_budget_bytes=hot.budget)


def log_hot(what: str, r: dict) -> None:
    log(f"  hot set ({what}): {r['hot_rows']} rows, "
        f"{r['hot_edge_share']:.2%} of the edges, budget "
        f"{r['hot_budget_bytes'] / 2**20:.0f} MiB; with no hot set "
        f"{r['hot0_ms']:.3f} ms (bitwise equal), with it {r['ms']:.3f} ms")


def log_product(kernel: str, what: str, r: dict) -> None:
    log(f"kernel {kernel} ({what}): max abs err {r['err']:.3e}, "
        f"{r['rel']:.3e} of max |y| (cuSPARSE {r['library_rel']:.3e}); "
        f"bitwise equal across two runs; {r['ms']:.3f} ms "
        f"(plain {r['plain_ms']:.3f}, torch.sparse.mm {r['library_ms']:.3f}, "
        f"bound {r['bound_ms']:.3f} by {r['bound_by']}, no-reuse gather "
        f"{r['gather_ms']:.3f}); the {HUB_ROWS} rows of highest degree "
        f"({r['hub_edge_share']:.1%} of the edges) alone {r['hub_ms']:.3f} ms "
        f"({r['hub_ms'] / r['ms']:.1%})")
    if "hot0_ms" in r:
        log_hot(what, r)
    if "nb" in r:
        log(f"  schedule ({what}): {r['nb']} source blocks of "
            f"{r['block_rows']} rows, segments of at most {r['segment']} "
            f"edges: {r['segments']} segments, {r['split_runs']} split runs, "
            f"{r['slots']} scratch slots, {r['plan_extra_bytes'] / 2**20:.1f} "
            f"MiB beyond the CSR; one source block (the row split alone) "
            f"{r['nb1_ms']:.3f} ms ({r['nb1_rel']:.3e} of max |y|)")


def seeded_rows(torch, n: int, dim: int, k: int, seed: int, dev):
    """utils/rows.py's seeded rows (random normal rows [n, dim] from `seed`
    with integer, zero and family rows: more than 32 keys sharing the
    pivot's high bits, repeated values, signed zeros, subnormals,
    infinities, exactly k and fewer nonzeros), and a random cotangent."""
    from spgemm_gnn_tpu_torch.utils import rows
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = rows.seeded_rows(n, dim, k, gen)
    return x, torch.randn((n, dim), generator=gen, device=dev)


def equal_nan(torch, a, b) -> bool:
    """f32 or bf16 a and b bitwise equal but where both are NaN (a dropped
    infinity's x * 0)."""
    both = a.isnan() & b.isnan()
    a, b = torch.where(both, 0, a), torch.where(both, 0, b)
    ints = torch.int16 if a.element_size() == 2 else torch.int32
    return bool(torch.equal(a.view(ints), b.view(ints)))


def maxk_phase(torch, n: int, dim: int, k: int, seed: int,
               dev) -> list[dict]:
    """K1, K2 at [n, dim]: maxk_fwd (y and meta) and maxk_bwd bitwise
    against their plain versions on `seeded_rows`, timed beside the plain
    versions, torch.topk and the bound."""
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_bwd, maxk_fwd
    from spgemm_gnn_tpu_torch.ops.maxk import maxk_backward, maxk_forward

    x, gy = seeded_rows(torch, n, dim, k, seed, dev)
    f32 = 4
    out = []

    # K1 maxk_fwd
    y, meta = maxk_fwd(x, k)
    y_p, meta_p = maxk_forward(x, k)
    torch.cuda.synchronize()
    if not (equal_nan(torch, y, y_p) and bits_equal(torch, meta, meta_p)):
        raise AssertionError("maxk_fwd differs from its plain version")
    b, by = bound_ms(2 * n * dim * f32 + n * 2 * 4, n * dim)
    out.append(dict(
        name="maxk_fwd", route="cuda", source="spgemm_gnn_tpu_torch/csrc/maxk.cu",
        replaces="spgemm_gnn_tpu/kernels/maxk_pallas.py:76",
        max_abs_err=float((y - y_p).nan_to_num().abs().max()),
        ms=time_ms(torch, lambda: maxk_fwd(x, k), 20),
        plain_ms=time_ms(torch, lambda: maxk_forward(x, k), 3),
        bound_ms=b, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.topk(x, k, dim=1), 20)))
    log(f"kernel maxk_fwd: bitwise equal to plain (y and meta), N={n} "
        f"dim={dim} k={k}; {out[-1]['ms']:.3f} ms (plain "
        f"{out[-1]['plain_ms']:.3f}, torch.topk {out[-1]['library_ms']:.3f}, "
        f"bound {b:.3f} by {by})")
    del y_p, meta_p

    # K2 maxk_bwd
    dx = maxk_bwd(x, meta, gy)
    dx_p = maxk_backward(x, meta, gy)
    torch.cuda.synchronize()
    if not equal_nan(torch, dx, dx_p):
        raise AssertionError("maxk_bwd differs from its plain version")
    b, by = bound_ms(3 * n * dim * f32 + n * 2 * 4, n * dim)
    out.append(dict(
        name="maxk_bwd", route="cuda", source="spgemm_gnn_tpu_torch/csrc/maxk.cu",
        replaces="spgemm_gnn_tpu/kernels/maxk_pallas.py:133",
        max_abs_err=float((dx - dx_p).nan_to_num().abs().max()),
        ms=time_ms(torch, lambda: maxk_bwd(x, meta, gy), 20),
        plain_ms=time_ms(torch, lambda: maxk_backward(x, meta, gy), 3),
        bound_ms=b, bound_by=by, library_ms=None))
    log(f"kernel maxk_bwd: bitwise equal to plain, N={n}; "
        f"{out[-1]['ms']:.3f} ms (bound {b:.3f} by {by})")
    return out


MAXK_KEYS = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")


def add_products(entries: list[dict], products: list[dict]) -> None:
    """The products-shape numbers of the MaxK kernels under products_
    keys of their (Reddit) entries."""
    for entry, p in zip(entries, products):
        entry.update({"products_" + key: p[key]
                      for key in (*MAXK_KEYS, "f32_ms") if key in p})


def product_entry(name: str, a: dict, t: dict | None = None, **other) -> dict:
    """The kernels-line entry of an aggregation kernel: A (`a`), and Aᵀ and
    other graphs' uses under prefixed keys."""
    source = {"csr_spmm": "spgemm_gnn_tpu_torch/csrc/spmm.cu",
              "stream_spmm": "spgemm_gnn_tpu_torch/csrc/stream.cu"}[name]
    replaces = {"csr_spmm": "spgemm_gnn_tpu/kernels/spgemm_pallas.py:97",
                "stream_spmm": "spgemm_gnn_tpu/kernels/stream_pallas.py:37"}
    names = {"err": "max_abs_err", "hub_ms": "hub_rows_ms",
             "gather_ms": "no_reuse_gather_ms"}
    keys = ("err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "hub_ms", "gather_ms", "nb", "segments", "split_runs", "nb1_ms",
            *HOT_KEYS)
    entry = dict(name=name, route="cuda", source=source,
                 replaces=replaces[name])
    for prefix, r in (("", a), ("transpose_", t), *other.items()):
        if r is not None:
            entry.update({prefix + names.get(key, key): r[key]
                          for key in keys if key in r})
    return entry


def _model_run(torch, name: str, g, feats, seed: int, nonlinear: str,
               impl: str):
    """(logits, input gradient) of a 2-layer, hidden-256 model of family
    `name` (LayerNorm or BatchNorm on, dropout off) on the graph."""
    from spgemm_gnn_tpu_torch.models.models import build_model
    model = build_model(name, in_dim=feats.shape[1], hidden_dim=HIDDEN,
                        num_layers=2, out_dim=41, maxk=K, feat_drop=0.0,
                        use_norm=True, nonlinear=nonlinear, impl=impl)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    model.to(feats.device)
    x = feats.clone().requires_grad_(True)
    logits = model(g, x)
    (logits.square().sum()).backward()
    return logits.detach(), x.grad


class ReluPattern:
    """Stands in for `torch.relu` in the model check: on the first run it
    records each call's mask (x > 0); on the second (after `replay()`) it
    applies the recorded masks in the same order, so that both runs take the
    same ReLU pattern, and counts the units whose sign differs. A ReLU after
    an aggregation (every family has one from its second layer on) can see a
    pre-activation within f32 rounding of 0, and the plain path adds with
    atomics, in an order that changes from run to run: without the replay
    one such unit flips its derivative in some runs, and its gradient
    reaches every neighbour's input row."""

    def __init__(self, torch):
        self.relu = torch.relu
        self.masks: list = []
        self.pos = None
        self.flips = 0

    def replay(self) -> None:
        self.pos = 0

    def __call__(self, x):
        if self.pos is None:
            self.masks.append(x > 0)
            return self.relu(x)
        mask = self.masks[self.pos]
        self.pos += 1
        self.flips += int(((x > 0) != mask).sum())
        return x * mask


def model_check(torch, seed: int, kind: str) -> None:
    """Every family through the kernels against the same family through the
    plain versions, on the same card: 3000 nodes, 2 layers, ReLU (so that no
    top-k selection can flip on a last-bit difference of the summation
    order), so only the aggregation kernel is held here at the model level:
    logits and input gradient within 1e-4 of their largest magnitude, the
    plain run taking the kernel run's ReLU pattern (`ReluPattern`).
    On the stream plan, each family with MaxK also runs with
    STREAM_CBSR_FORWARD at its default (None: the rule, which takes
    stream_cbsr_spmm at hidden 256) and off: the logits and input gradients
    must be equal by value, and the default run must launch
    stream_cbsr_spmm once per layer of a family that aggregates a k-sparse
    input."""
    from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph
    from spgemm_gnn_tpu_torch.kernels import _build, planned
    from spgemm_gnn_tpu_torch.models.models import MODELS

    dev = torch.device("cuda")
    g = planned.plan_graph(powerlaw_graph(3000, 60000, seed=seed).to(dev),
                           kind=kind)
    gen = torch.Generator(device=dev).manual_seed(seed)
    feats = torch.randn((g.num_nodes, 64), generator=gen, device=dev)
    for name in MODELS:
        pattern = ReluPattern(torch)
        torch.relu = pattern
        try:
            got = _model_run(torch, name, g, feats, seed, "relu", "cuda")
            pattern.replay()
            want = _model_run(torch, name, g, feats, seed, "relu", "torch")
        finally:
            torch.relu = pattern.relu
        rels = []
        for what, a, b in zip(("logits", "input grad"), got, want):
            if not (torch.isfinite(a).all() and a.shape == b.shape):
                raise AssertionError(f"model check ({name}): {what} not "
                                     f"finite or misshaped")
            rels.append(rel_err(a, b)[1])
            if not rels[-1] <= 1e-4:
                raise AssertionError(f"model check ({kind}, {name}): {what} "
                                     f"error {rels[-1]:.3e}")
        log(f"model check ({kind} plan, {name}, ReLU): kernels vs plain, "
            f"logits {rels[0]:.3e}, input grad {rels[1]:.3e} of max; "
            f"{pattern.flips} ReLU units of the plain run on the other side "
            f"of 0")
    if kind != "stream":
        return
    for name in MODELS:
        runs = {}
        for flag in (None, False):     # the default rule, then forced off
            planned.STREAM_CBSR_FORWARD = flag
            _build.launches.clear()
            runs[flag] = (_model_run(torch, name, g, feats, seed, "maxk",
                                     "cuda"), dict(_build.launches))
        planned.STREAM_CBSR_FORWARD = None
        (on, counts), (off, _) = runs[None], runs[False]
        if not all(torch.equal(a, b) for a, b in zip(on, off)):
            raise AssertionError(f"model check ({name}, MaxK): the default "
                                 f"model differs from the flag-off one")
        want = 0 if name == "gnn_res" else 2      # gnn_res is ReLU-only
        if counts.get("stream_cbsr_spmm", 0) != want:
            raise AssertionError(f"model check ({name}, MaxK): launches "
                                 f"{counts}, expected stream_cbsr_spmm "
                                 f"{want}")
    log(f"model check (stream plan, {len(MODELS)} families, MaxK k={K}): "
        f"STREAM_CBSR_FORWARD at its default (the rule) and off give equal "
        f"logits and input gradients; the default launched "
        f"stream_cbsr_spmm once per layer")


def stream_cbsr_check(torch, g, dim: int, k: int, seed: int) -> dict:
    """stream_cbsr_spmm on A of the graph at (dim, k), under the mean (post
    only) and gcn (pre and post) factors: within 1e-5 of max |y| of the
    plain version in float64 (on the same masked input, which the records
    hold), equal by value to stream_spmm on that input, bitwise equal across
    two runs and to a run with no hot set. Timed beside stream_spmm on that
    input, the plain version, torch.sparse.mm on the dense input, the run
    with no hot set, and cbsr_compact + cbsr_records + stream_cbsr_spmm (the
    default forward on a stream plan). Returns the kernels-line entry (mean
    factors; gcn under prefixed keys)."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.kernels.cbsr import cbsr_compact
    from spgemm_gnn_tpu_torch.kernels.stream import (stream_cbsr_spmm,
                                                     stream_cbsr_spmm_at,
                                                     stream_spmm)
    from spgemm_gnn_tpu_torch.ops.maxk import (cbsr_records,
                                               packed_channel_words)
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.stream import (stream_cbsr_spmm_plain,
                                                 stream_spmm_plain)

    n, e = g.num_nodes, g.num_edges
    plan = build_stream_plan(g.indptr, g.indices)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    xs = sparse_input(torch, n, dim, k, gen)
    vals, ch = cbsr_compact(xs, k)
    rec = cbsr_records(vals, ch, dim)
    del vals, ch
    kp = packed_channel_words(k, dim)
    hot = hot_keys(plan.hot_set(4 * (k + kp)))
    gathered = torch.bincount(g.indices, minlength=n).double()
    ops = 2.0 * float(((xs != 0).sum(1).double() * gathered).sum())
    entry = dict(name="stream_cbsr_spmm", route="cuda",
                 source="spgemm_gnn_tpu_torch/csrc/stream.cu",
                 replaces="spgemm_gnn_tpu/kernels/stream_pallas.py:90")
    for norm in ("mean", "gcn"):
        pre, post = node_factors(g, norm)

        def run():
            return stream_cbsr_spmm(plan, rec, k, dim, pre, post)

        def run_hot0():
            return stream_cbsr_spmm_at(plan, rec, k, dim, pre, post,
                                       hot_budget=0)

        def run_with_compact():
            v, c = cbsr_compact(xs, k)
            return stream_cbsr_spmm(plan, cbsr_records(v, c, dim), k, dim,
                                    pre, post)

        got, again = run(), run()
        ref = stream_spmm_plain(plan, xs.double(), pre, post)
        dense = stream_spmm(plan, xs, pre, post)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not rel <= 1e-5:
            raise AssertionError(f"stream_cbsr_spmm ({norm}) error {rel:.3e} "
                                 f"of max |y| > 1e-5")
        if not torch.equal(got, dense):
            raise AssertionError(f"stream_cbsr_spmm ({norm}) differs from "
                                 f"stream_spmm on the same input")
        if not bits_equal(torch, got, again):
            raise AssertionError(f"stream_cbsr_spmm ({norm}): two runs differ")
        if not bits_equal(torch, got, run_hot0()):
            raise AssertionError(f"stream_cbsr_spmm ({norm}): hot budget 0 "
                                 f"differs from the default")
        del ref, again, dense
        w = torch.ones(e, device="cuda")
        if pre is not None:
            w = w * pre[g.indices.long()]
        w = w * post[g.edge_dst.long()]
        a = torch.sparse_csr_tensor(g.indptr, g.indices, w, size=(n, n))
        n_bytes = (n * k * 4 + n * kp * 4 + e * 4 + (n + 1) * 4
                   + n * dim * 4 + (plan.num_chunks + plan.carry_rows.numel())
                   * 4 + 4 * n * ((pre is not None) + (post is not None)))
        b_ms, b_by = bound_ms(n_bytes, ops)
        gather_ms = e * (k * 4 + kp * 4 + 4) / PEAK_BYTES_S * 1e3
        r = dict(max_abs_err=err, rel=rel, ms=time_ms(torch, run, 10),
                 stream_spmm_ms=time_ms(
                     torch, lambda: stream_spmm(plan, xs, pre, post), 5),
                 plain_ms=time_ms(torch, lambda: stream_cbsr_spmm_plain(
                     plan, rec, k, dim, pre, post), 2),
                 library_ms=time_ms(torch, lambda: torch.sparse.mm(a, xs), 5),
                 compact_and_ms=time_ms(torch, run_with_compact, 10),
                 hot0_ms=time_ms(torch, run_hot0, 10), **hot,
                 bound_ms=b_ms, bound_by=b_by, no_reuse_gather_ms=gather_ms)
        del a, w
        log(f"kernel stream_cbsr_spmm (products, A, {norm} factors, dim "
            f"{dim}, k {k}): max abs err {err:.3e}, {rel:.3e} of max |y|; "
            f"equal by value to stream_spmm; bitwise equal across two runs; "
            f"{r['ms']:.3f} ms (stream_spmm on the same input "
            f"{r['stream_spmm_ms']:.3f}, plain {r['plain_ms']:.3f}, "
            f"torch.sparse.mm {r['library_ms']:.3f}, bound {b_ms:.3f} by "
            f"{b_by}, no-reuse gather {gather_ms:.3f}; "
            f"cbsr_compact + records + stream_cbsr_spmm "
            f"{r['compact_and_ms']:.3f})")
        log_hot(f"stream_cbsr_spmm, {norm} factors", r)
        if norm == "mean":
            entry.update({key: r[key] for key in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms", "stream_spmm_ms", "compact_and_ms",
                "no_reuse_gather_ms", *HOT_KEYS)})
        else:
            entry.update({f"gcn_{key}": r[key] for key in (
                "max_abs_err", "ms", "bound_ms", "stream_spmm_ms",
                "library_ms", "hot0_ms")})
    return entry


def library16(torch, indptr, indices, w, n: int, x16):
    """(ms, error) of `torch.sparse.mm` on a bf16 CSR tensor of the edge
    weights times the bf16 rows: the library call of the 16-bit products.
    A call the card's PyTorch refuses gives (None, its error)."""
    try:
        a = torch.sparse_csr_tensor(indptr, indices, w.to(torch.bfloat16),
                                    size=(n, n))
        torch.sparse.mm(a, x16)
        torch.cuda.synchronize()
        return time_ms(torch, lambda: torch.sparse.mm(a, x16), 5), None
    except (RuntimeError, NotImplementedError) as err:
        return None, f"{type(err).__name__}: {str(err).splitlines()[0][:160]}"


def product16_check(torch, kernel: str, g, inp, pre_f, post_f, f32: dict,
                    transpose: bool = False) -> dict:
    """Check and time the bf16 form of an aggregation kernel ("csr_spmm" or
    "stream_spmm") on the graph's CSR (or its transpose), as the planner
    runs it under the 16-bit stream: the messages round_rows(inp, pre_f),
    the kernel with no pre factor. Held within 1e-5 of max |y| of the plain
    version run in float64 on the same bf16 rows, bitwise equal across two
    runs (the stream kernel also with no hot set), and timed beside its f32
    form on the same input (`f32`, product_check's result), the plain
    version, the bound, the no-reuse gather of 2-byte rows and
    torch.sparse.mm on a bf16 CSR tensor."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
    from spgemm_gnn_tpu_torch.kernels.stream import stream_spmm, stream_spmm_at
    from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain
    from spgemm_gnn_tpu_torch.ops.stream import stream_spmm_plain

    indptr = g.t_indptr if transpose else g.indptr
    indices = g.t_indices if transpose else g.indices
    rows = g.t_edge_dst if transpose else g.edge_dst
    n, e, dim = g.num_nodes, g.num_edges, inp.shape[1]
    x16 = round_rows(inp, pre_f)
    if kernel == "stream_spmm":
        plan = build_stream_plan(indptr, indices)
        plan_bytes = (plan.num_chunks + plan.carry_rows.numel()) * 4

        def run():
            return stream_spmm(plan, x16, None, post_f)

        def run_plain(x):
            return stream_spmm_plain(plan, x, None, post_f)
    else:
        plan = CSRPlan(indptr, indices)
        plan_bytes = 0

        def run():
            return csr_spmm(plan, x16, None, post_f)

        def run_plain(x):
            return csr_spmm_plain(indptr, indices, x, None, post_f)

    ref = run_plain(x16.double())
    got, again = run(), run()
    torch.cuda.synchronize()
    err, rel = rel_err(got, ref)
    if not rel <= 1e-5:
        raise AssertionError(f"{kernel} (bf16) error {rel:.3e} of max |y| > "
                             f"1e-5")
    if not bits_equal(torch, got, again):
        raise AssertionError(f"{kernel} (bf16): two runs differ")
    del ref, again
    extra = {}
    if kernel == "stream_spmm":
        def run_hot0():
            return stream_spmm_at(plan, x16, None, post_f, hot_budget=0)
        if not bits_equal(torch, got, run_hot0()):
            raise AssertionError("stream_spmm (bf16): hot budget 0 differs "
                                 "from the default")
        extra = hot_keys(plan.hot_set(2 * dim))
        extra["hot0_ms"] = time_ms(torch, run_hot0, 5)
    else:
        sched = plan.schedule(n, dim, 2)
        extra = dict(nb=sched.nb, block_rows=sched.block_rows,
                     segments=sched.num_segments,
                     split_runs=sched.num_split_runs)
    w = torch.ones(e, device=inp.device)
    if post_f is not None:
        w = w * post_f[rows.long()]
    lib_ms, lib_err = library16(torch, indptr, indices, w, n, x16)
    del w
    gathered = torch.bincount(indices, minlength=n).double()
    ops = 2.0 * float(((x16 != 0).sum(1).double() * gathered).sum())
    n_bytes = (n * dim * 2 + n * dim * 4 + (n + 1) * 4 + e * 4 + plan_bytes
               + 4 * n * (post_f is not None))
    b_ms, b_by = bound_ms(n_bytes, ops)
    return dict(err=err, rel=rel, bound_ms=b_ms, bound_by=b_by,
                ms=time_ms(torch, run, 5), f32_ms=f32["ms"],
                plain_ms=time_ms(torch, lambda: run_plain(x16), 2),
                library_ms=lib_ms, library_error=lib_err,
                gather_ms=e * dim * 2 / PEAK_BYTES_S * 1e3, **extra)


def log_product16(kernel: str, what: str, r: dict) -> None:
    lib = (f"{r['library_ms']:.3f}" if r["library_ms"] is not None
           else f"none ({r['library_error']})")
    log(f"kernel {kernel}_bf16 ({what}): max abs err {r['err']:.3e}, "
        f"{r['rel']:.3e} of max |y| against float64 on the same bf16 rows; "
        f"bitwise equal across two runs; {r['ms']:.3f} ms (f32 form "
        f"{r['f32_ms']:.3f}, plain {r['plain_ms']:.3f}, torch.sparse.mm bf16 "
        f"{lib}, bound {r['bound_ms']:.3f} by {r['bound_by']}, no-reuse "
        f"gather of 2-byte rows {r['gather_ms']:.3f})")
    if "hot0_ms" in r:
        log_hot(f"{what}, bf16", r)
    if "nb" in r:
        log(f"  schedule ({what}, bf16 rows): {r['nb']} source blocks of "
            f"{r['block_rows']} rows, {r['segments']} segments, "
            f"{r['split_runs']} split runs")


def entry16(name: str, source: str, replaces: str, a: dict,
            t: dict | None = None) -> dict:
    """The kernels-line entry of a 16-bit kernel: A (`a`), Aᵀ (`t`) under
    prefixed keys."""
    names = {"err": "max_abs_err", "gather_ms": "no_reuse_gather_ms",
             **NEAR_KEYS}
    keys = ("err", "max_abs_err", "ms", "f32_ms", "plain_ms", "bound_ms",
            "bound_by", "library_ms", "library_error", "gather_ms",
            "no_reuse_gather_ms", "nb", *NEAR_KEYS, *HOT_KEYS)
    entry = dict(name=name, route="cuda", source=source, replaces=replaces)
    for prefix, r in (("", a), ("transpose_", t)):
        if r is not None:
            entry.update({prefix + names.get(key, key): r[key]
                          for key in keys if key in r})
    return entry


def round_rows_check(torch, n: int, dim: int, pre, seed: int) -> dict:
    """round_rows at [n, dim] with a node factor: bitwise equal to its plain
    version, timed beside it and against its bound (each f32 read once,
    each bf16 written once)."""
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.ops.spmm import round_rows_plain
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((n, dim), generator=gen, device="cuda")
    got, want = round_rows(x, pre), round_rows_plain(x, pre)
    torch.cuda.synchronize()
    if not bool(torch.equal(got.view(torch.int16), want.view(torch.int16))):
        raise AssertionError("round_rows differs from its plain version")
    err = float((got.float() - want.float()).abs().max())
    b_ms, b_by = bound_ms(n * dim * 4 + n * dim * 2 + 4 * n, n * dim)
    r = dict(name="round_rows", route="cuda",
             source="spgemm_gnn_tpu_torch/csrc/round.cu",
             replaces="spgemm_gnn_tpu/kernels/spgemm_pallas.py:433 "
                      "(_pack_bf16x2's rounding and stream_pallas.py:227; "
                      "XLA glue in the JAX package, no pallas_call)",
             max_abs_err=err, ms=time_ms(torch, lambda: round_rows(x, pre), 20),
             plain_ms=time_ms(torch, lambda: round_rows_plain(x, pre), 5),
             bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"kernel round_rows (N={n}, dim {dim}, with a node factor): bitwise "
        f"equal to plain; {r['ms']:.3f} ms (plain {r['plain_ms']:.3f}, bound "
        f"{b_ms:.3f} by {b_by})")
    return r


def cbsr16_diagnosis(torch, plan, rec, k: int, dim: int, post,
                     out16: bool) -> dict:
    """What holds the bf16-record kernel (stream_cbsr16_kernel) at the
    call's shape, at its default batch: its SASS instruction count, its
    loops (each backward branch with the instructions from its target) and
    the instructions of one steady stage (`cuobjdump -sass` of the built
    library, utils/stream_sweep.py::sass_loops), its registers, local
    (spill) bytes and resident warps an SM (stream_cbsr16_attrs), and the
    ms of its two timing variants, never on the path, whose y is wrong by
    design: no_load (the records of the first stages only: the walk and the
    scatter) and no_scatter (every record loaded, nothing scattered: the
    walk and the gather)."""
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.kernels.stream import (BATCHES16, _slices,
                                                     stream_cbsr16_attrs,
                                                     stream_cbsr_spmm_at)
    from spgemm_gnn_tpu_torch.utils.stream_sweep import sass_loops
    kv = _slices(k)
    batch = BATCHES16[kv][0]
    eps = 1 if kv >= 4 else 4 // kv
    pattern = (f"stream_cbsr16_kernelILi{kv}ELi{batch // eps}ELb"
               f"{int(out16)}ELi0E")
    sass = [r for name, r in sass_loops(_build._target("stream"), pattern,
                                        None, 128 * kv * (eps - 1)).items()]
    if len(sass) != 1:
        raise AssertionError(f"SASS of {pattern}: {len(sass)} kernels found")
    od = torch.bfloat16 if out16 else None
    variants = {}
    for variant in ("no_load", "no_scatter"):
        def run(variant=variant):
            return stream_cbsr_spmm_at(plan, rec, k, dim, None, post,
                                       variant=variant,
                                       value_dtype=torch.bfloat16,
                                       out_dtype=od)
        variants[f"{variant}_ms"] = time_ms(torch, run, 10)
    loops = [(lp["start"], lp["instructions"]) for lp in sass[0]["loops"]
             if lp["instructions"] > 1]
    return dict(sass_instructions=sass[0]["instructions"], sass_loops=loops,
                stage_instructions=sass[0]["stage"], stage_edges=eps,
                **stream_cbsr16_attrs(k, dim, batch, None, out16),
                **variants)


def log_diagnosis(name: str, d: dict) -> None:
    log(f"  diagnosis {name}: {d['sass_instructions']} SASS instructions, "
        f"loops (start, instructions) "
        f"{[(hex(a), n) for a, n in d['sass_loops']]}; a steady stage of "
        f"{d['stage_edges']} edges {d['stage_instructions']} instructions; "
        f"{d['regs']} "
        f"registers, {d['local_bytes']} local bytes a thread, "
        f"{d['warps_per_sm']} resident warps an SM; timing variants (wrong "
        f"y): no_load {d['no_load_ms']:.3f} ms (the walk and the scatter), "
        f"no_scatter {d['no_scatter_ms']:.3f} ms (the walk and the gather)")


DIAG_KEYS = ("sass_instructions", "stage_instructions", "regs",
             "local_bytes", "warps_per_sm", "no_load_ms", "no_scatter_ms")


def stream_cbsr16_check(torch, g, dim: int, k: int, seed: int,
                        f32: dict) -> dict:
    """stream_cbsr_spmm_bf16 on A of the graph at (dim, k), under the mean
    and gcn factors, on the 16-bit stream's records (the CBSR values
    rounded after the pre factor, 128 B at k 32): within 1e-5 of max |y| of
    the plain version in float64 on the same values, equal by value to
    stream_spmm_bf16 on the same masked input, bitwise equal across two runs
    and to a run with no hot set. Timed beside its f32 form (`f32`,
    stream_cbsr_check's entry), the plain version, the bound and the
    no-reuse gather of the bytes a record needs (`bf16_record_bytes`), the
    no-reuse gather of its 128-B records and torch.sparse.mm on a bf16 CSR
    tensor, with `cbsr16_diagnosis`."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.kernels.cbsr import cbsr_compact
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.stream import (stream_cbsr_spmm,
                                                     stream_cbsr_spmm_at,
                                                     stream_spmm)
    from spgemm_gnn_tpu_torch.ops.maxk import cbsr_records, cbsr_to_dense
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.stream import (stream_cbsr_spmm_plain,
                                                 stream_spmm_plain)

    bf16 = torch.bfloat16
    n, e = g.num_nodes, g.num_edges
    plan = build_stream_plan(g.indptr, g.indices)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    xs = sparse_input(torch, n, dim, k, gen)
    vals, ch = cbsr_compact(xs, k)
    del xs
    entry = dict(name="stream_cbsr_spmm_bf16", route="cuda",
                 source="spgemm_gnn_tpu_torch/csrc/stream.cu",
                 replaces="spgemm_gnn_tpu/kernels/stream_pallas.py:90 "
                          "(bf16 values, :158-159)")
    for norm in ("mean", "gcn"):
        pre, post = node_factors(g, norm)
        v16 = round_rows(vals, pre)
        rec = cbsr_records(v16, ch, dim)
        dense = cbsr_to_dense(v16.float(), ch, dim).to(bf16)
        del v16

        def run():
            return stream_cbsr_spmm(plan, rec, k, dim, None, post, bf16)

        got, again = run(), run()
        ref = stream_spmm_plain(plan, dense.double(), None, post)
        by_b3 = stream_spmm(plan, dense, None, post)
        torch.cuda.synchronize()
        err, rel = rel_err(got, ref)
        if not rel <= 1e-5:
            raise AssertionError(f"stream_cbsr_spmm_bf16 ({norm}) error "
                                 f"{rel:.3e} of max |y| > 1e-5")
        if not torch.equal(got, by_b3):
            raise AssertionError(f"stream_cbsr_spmm_bf16 ({norm}) differs "
                                 f"from stream_spmm_bf16 on the same input")
        if not bits_equal(torch, got, again):
            raise AssertionError(f"stream_cbsr_spmm_bf16 ({norm}): two runs "
                                 f"differ")

        def run_hot0():
            return stream_cbsr_spmm_at(plan, rec, k, dim, None, post,
                                       hot_budget=0, value_dtype=bf16)
        if not bits_equal(torch, got, run_hot0()):
            raise AssertionError(f"stream_cbsr_spmm_bf16 ({norm}): hot budget "
                                 f"0 differs from the default")
        del ref, again, by_b3
        row, need = rec.shape[1] * 4, bf16_record_bytes(k)
        lib_ms, lib_err = library16(torch, g.indptr, g.indices,
                                    post[g.edge_dst.long()], n, dense)
        gathered = torch.bincount(g.indices, minlength=n).double()
        ops = 2.0 * float(((dense != 0).sum(1).double() * gathered).sum())
        n_bytes = (n * need + e * 4 + (n + 1) * 4 + n * dim * 4
                   + (plan.num_chunks + plan.carry_rows.numel()) * 4 + 4 * n)
        b_ms, b_by = bound_ms(n_bytes, ops)
        r = dict(max_abs_err=err, rel=rel, ms=time_ms(torch, run, 10),
                 f32_ms=f32["ms"] if norm == "mean" else f32["gcn_ms"],
                 plain_ms=time_ms(torch, lambda: stream_cbsr_spmm_plain(
                     plan, rec, k, dim, None, post, bf16), 2),
                 library_ms=lib_ms, library_error=lib_err,
                 hot0_ms=time_ms(torch, run_hot0, 10),
                 **hot_keys(plan.hot_set(row)), record_bytes=row,
                 need_bytes=need, bound_ms=b_ms, bound_by=b_by,
                 no_reuse_gather_ms=e * (need + 4) / PEAK_BYTES_S * 1e3,
                 layout_gather_ms=e * (row + 4) / PEAK_BYTES_S * 1e3)
        if norm == "mean":
            r.update(cbsr16_diagnosis(torch, plan, rec, k, dim, post, False))
        del dense, rec
        lib = (f"{lib_ms:.3f}" if lib_ms is not None else f"none ({lib_err})")
        log(f"kernel stream_cbsr_spmm_bf16 (products, A, {norm} factors, dim "
            f"{dim}, k {k}, {row}-B records): max abs err {err:.3e}, "
            f"{rel:.3e} of max |y|; equal by value to stream_spmm_bf16; "
            f"bitwise equal across two runs; {r['ms']:.3f} ms (f32 form "
            f"{r['f32_ms']:.3f}, plain {r['plain_ms']:.3f}, torch.sparse.mm "
            f"bf16 {lib}, bound {b_ms:.3f} by {b_by} and no-reuse gather "
            f"{r['no_reuse_gather_ms']:.3f} on the {need} B a record needs; "
            f"the {row}-B layout's no-reuse gather "
            f"{r['layout_gather_ms']:.3f})")
        log_hot(f"stream_cbsr_spmm_bf16, {norm} factors", r)
        if norm == "mean":
            log_diagnosis("stream_cbsr_spmm_bf16", r)
            entry.update({key: r[key] for key in (
                "max_abs_err", "ms", "f32_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_error", "record_bytes",
                "need_bytes", "no_reuse_gather_ms", "layout_gather_ms",
                *HOT_KEYS, *DIAG_KEYS)})
        else:
            entry.update({f"gcn_{key}": r[key] for key in (
                "max_abs_err", "ms", "f32_ms", "bound_ms", "hot0_ms")})
    return entry


def first_steps16(torch, cfg, ds, what: str, tol: float = 1e-4) -> None:
    """Under the 16-bit stream or the 16-bit model: the first two train
    steps through the kernels against the same planned path through the
    plain versions (every wrapper made to take its plain version, so that
    both round the same messages), same weights and dropout seed, losses
    within `tol` relative."""
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    first = {}
    for plain in (False, True):
        real = _build.on_cpu
        if plain:
            _build.on_cpu = lambda t: True
        try:
            tr = Trainer(cfg, dataset=ds)
            state = tr.init_state()
            drop = torch.Generator(device=tr.device).manual_seed(SEED + 1)
            first[plain] = [float(tr.train_step(state, drop))
                            for _ in range(2)]
        finally:
            _build.on_cpu = real
        del tr, state
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(first[False], first[True])]
    if not max(rel) <= tol:
        raise AssertionError(f"{what}: first steps {first[False]} vs plain "
                             f"{first[True]} ({rel})")
    log(f"{what}: first two steps through the kernels {first[False]}, the "
        f"plain versions with the same stream and dtype {first[True]}, "
        f"relative {rel} (tolerance {tol})")


def maxk16_phase(torch, n: int, dim: int, k: int, seed: int, dev,
                 f32: list[dict]) -> list[dict]:
    """B1 on bf16 rows (the 16-bit model): maxk_fwd_bf16 (y and meta) and
    maxk_bwd_bf16 bitwise against their plain versions at [n, dim], on
    `seeded_rows` rounded to bf16, timed beside their f32 forms (`f32`,
    maxk_phase's entries at the same shape), the plain versions, torch.topk
    on the bf16 rows and the bound."""
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_bwd, maxk_fwd
    from spgemm_gnn_tpu_torch.ops.maxk import maxk_backward, maxk_forward

    x, gy = seeded_rows(torch, n, dim, k, seed, dev)
    x, gy = x.to(torch.bfloat16), gy.to(torch.bfloat16)
    y, meta = maxk_fwd(x, k)
    y_p, meta_p = maxk_forward(x, k)
    dx = maxk_bwd(x, meta, gy)
    dx_p = maxk_backward(x, meta, gy)
    torch.cuda.synchronize()
    if not (equal_nan(torch, y, y_p) and bits_equal(torch, meta, meta_p)):
        raise AssertionError("maxk_fwd_bf16 differs from its plain version")
    if not equal_nan(torch, dx, dx_p):
        raise AssertionError("maxk_bwd_bf16 differs from its plain version")
    kth = torch.sort(x.float(), dim=1, descending=True).values[:, k - 1:k]
    ties = int(((x.float() == kth).sum(1) > 1).sum())
    del kth
    out = []
    for name, f32_entry, fn, fn_plain, n_bytes, lib, got, want in (
            ("maxk_fwd_bf16", f32[0], lambda: maxk_fwd(x, k),
             lambda: maxk_forward(x, k), 2 * n * dim * 2 + n * 2 * 4,
             lambda: torch.topk(x, k, dim=1), y, y_p),
            ("maxk_bwd_bf16", f32[1], lambda: maxk_bwd(x, meta, gy),
             lambda: maxk_backward(x, meta, gy), 3 * n * dim * 2 + n * 2 * 4,
             None, dx, dx_p)):
        b, by = bound_ms(n_bytes, n * dim)
        out.append(dict(
            name=name, route="cuda",
            source="spgemm_gnn_tpu_torch/csrc/maxk.cu",
            replaces=f32_entry["replaces"] + " (bf16 rows, :38, :80, :119)",
            max_abs_err=float((got.float() - want.float()).nan_to_num()
                              .abs().max()),
            ms=time_ms(torch, fn, 20), f32_ms=f32_entry["ms"],
            plain_ms=time_ms(torch, fn_plain, 3), bound_ms=b, bound_by=by,
            library_ms=None if lib is None else time_ms(torch, lib, 20)))
        log(f"kernel {name}: bitwise equal to plain, N={n} dim={dim} k={k} "
            f"({ties} rows with a tie at the k-th value); "
            f"{out[-1]['ms']:.3f} ms (f32 form {f32_entry['ms']:.3f}, plain "
            f"{out[-1]['plain_ms']:.3f}, library {out[-1]['library_ms']}, "
            f"bound {b:.3f} by {by})")
    return out


def compact16_check(torch, n: int, dim: int, k: int, seed: int,
                    f32_ms: float) -> dict:
    """B7 on bf16 rows: cbsr_compact_bf16 at [n, dim] on the training
    path's input (MaxK, then dropout 0.5) in bf16, values and channels
    bitwise against the plain version, timed beside its f32 form (`f32_ms`),
    the plain version and the bound; then bitwise on the bf16 MaxK of
    `seeded_rows` (the row families: signed zeros, subnormals, NaN from a
    dropped infinity, exactly k and fewer nonzeros)."""
    from spgemm_gnn_tpu_torch.kernels.cbsr import cbsr_compact
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_fwd
    from spgemm_gnn_tpu_torch.ops.maxk import cbsr_compact_plain
    x16 = seeded_rows(torch, n, dim, k, seed + 1, "cuda")[0].to(
        torch.bfloat16)
    x16 = maxk_fwd(x16, k)[0]
    (v, c), (v_p, c_p) = cbsr_compact(x16, k), cbsr_compact_plain(x16, k)
    torch.cuda.synchronize()
    if not (equal_nan(torch, v, v_p) and torch.equal(c, c_p)):
        raise AssertionError("cbsr_compact_bf16 differs from its plain "
                             "version on the row families")
    del x16, v, c, v_p, c_p
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = sparse_input(torch, n, dim, k, gen).to(torch.bfloat16)
    (v, c), (v_p, c_p) = cbsr_compact(xs, k), cbsr_compact_plain(xs, k)
    torch.cuda.synchronize()
    if not (bits_equal(torch, v, v_p) and torch.equal(c, c_p)):
        raise AssertionError("cbsr_compact_bf16 differs from its plain "
                             "version")
    b, by = bound_ms(n * dim * 2 + n * k * 2 + n * k * 4, 0.0)
    r = dict(name="cbsr_compact_bf16", route="cuda",
             source="spgemm_gnn_tpu_torch/csrc/cbsr.cu",
             replaces="spgemm_gnn_tpu/kernels/maxk_pallas.py:166 (values "
                      "in x's dtype, :177-186, :212)",
             max_abs_err=max(float((v.float() - v_p.float()).abs().max()),
                             float((c - c_p).abs().max())),
             ms=time_ms(torch, lambda: cbsr_compact(xs, k), 10),
             f32_ms=f32_ms,
             plain_ms=time_ms(torch, lambda: cbsr_compact_plain(xs, k), 3),
             bound_ms=b, bound_by=by, library_ms=None)
    log(f"kernel cbsr_compact_bf16: bitwise equal to plain (also on the "
        f"row families), N={n} dim={dim} k={k}; {r['ms']:.3f} ms (f32 form "
        f"{f32_ms:.3f}, plain {r['plain_ms']:.3f}, bound {b:.3f} by {by})")
    return r


def layer_norm16_check(torch, n: int, dim: int, seed: int) -> list[dict]:
    """The bf16 LayerNorm kernels at [n, dim] against their plain versions:
    y and dx within 1 bf16 ulp of their row's largest magnitude (a value
    near 0 sums larger terms), at most 0.5 % of them off (the statistics'
    f32 sums run in another order), mean and rstd
    within 1e-5 relative, dweight and dbias within 1e-5 of their largest
    magnitude, each kernel bitwise repeatable. Timed beside the plain
    versions, the bound and F.layer_norm on the bf16 rows with bf16
    parameters (the nearest one PyTorch call; it rounds the parameters and
    folds the affine step, so not the same function) and its backward."""
    import torch.nn.functional as F

    from spgemm_gnn_tpu_torch.kernels.layernorm import (layer_norm16_bwd,
                                                        layer_norm16_fwd)
    from spgemm_gnn_tpu_torch.ops.layernorm import (layer_norm16_backward,
                                                    layer_norm16_forward)
    bf16 = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (3 * torch.randn((n, dim), generator=gen, device="cuda") + 1).to(bf16)
    w = torch.rand(dim, generator=gen, device="cuda") + 0.5
    b = torch.randn(dim, generator=gen, device="cuda")
    g = torch.randn((n, dim), generator=gen, device="cuda").to(bf16)
    y, mean, rstd = layer_norm16_fwd(x, w, b, 1e-5)
    dx, dw, db = layer_norm16_bwd(x, mean, rstd, w, g)
    y_p, mean_p, rstd_p = layer_norm16_forward(x, w, b, 1e-5)
    dx_p, dw_p, db_p = layer_norm16_backward(x, mean, rstd, w, g)
    again = (layer_norm16_fwd(x, w, b, 1e-5)[0],
             layer_norm16_bwd(x, mean, rstd, w, g)[0])
    torch.cuda.synchronize()
    if not (bits_equal(torch, y, again[0]) and bits_equal(torch, dx,
                                                          again[1])):
        raise AssertionError("layer_norm16: two runs differ")
    worst = {}
    for what, a, e in (("y", y, y_p), ("dx", dx, dx_p)):
        a, e = a.float(), e.float()
        top = e.abs().amax(-1, keepdim=True).clamp(min=2.0 ** -120)
        ulps = (a - e).abs() / torch.exp2(torch.floor(torch.log2(top)) - 7)
        worst[what] = (float(ulps.max()), float((ulps > 0).float().mean()))
        if not (worst[what][0] <= 1 and worst[what][1] <= 0.005):
            raise AssertionError(f"layer_norm16 {what}: {worst[what]} (max "
                                 f"ulps of the row's largest, share off) "
                                 f"against plain")
    for what, a, e in (("mean", mean, mean_p), ("rstd", rstd, rstd_p)):
        if not bool(((a - e).abs() <= 1e-5 * e.abs() + 1e-6).all()):
            raise AssertionError(f"layer_norm16 {what}: beyond 1e-5 relative")
    for what, a, e in (("dweight", dw, dw_p), ("dbias", db, db_p)):
        if not float((a - e).abs().max()) <= 1e-5 * float(e.abs().max()):
            raise AssertionError(f"layer_norm16 {what}: beyond 1e-5 of max")
    xl = x.clone().requires_grad_(True)
    w16, b16 = (w.to(bf16).requires_grad_(True),
                b.to(bf16).requires_grad_(True))
    yl = F.layer_norm(xl, (dim,), w16, b16, 1e-5)
    out = []
    for name, fn, fn_plain, lib, n_bytes, got, want in (
            ("layer_norm16_fwd", lambda: layer_norm16_fwd(x, w, b, 1e-5),
             lambda: layer_norm16_forward(x, w, b, 1e-5),
             lambda: F.layer_norm(x, (dim,), w16, b16, 1e-5),
             2 * n * dim * 2 + n * 8 + 2 * dim * 4, y, y_p),
            ("layer_norm16_bwd",
             lambda: layer_norm16_bwd(x, mean, rstd, w, g),
             lambda: layer_norm16_backward(x, mean, rstd, w, g),
             lambda: torch.autograd.grad(yl, (xl, w16, b16), g,
                                         retain_graph=True),
             3 * n * dim * 2 + n * 8 + 2 * 1024 * dim * 4, dx, dx_p)):
        bnd, by = bound_ms(n_bytes, 8.0 * n * dim)
        out.append(dict(
            name=name, route="cuda",
            source="spgemm_gnn_tpu_torch/csrc/norm.cu",
            replaces="XLA glue in the JAX package (flax LayerNorm(dtype="
                     "bfloat16), no pallas_call)",
            max_abs_err=float((got.float() - want.float()).abs().max()),
            ms=time_ms(torch, fn, 10), plain_ms=time_ms(torch, fn_plain, 3),
            bound_ms=bnd, bound_by=by, library_ms=time_ms(torch, lib, 10),
            library_call="F.layer_norm on bf16 rows with bf16 parameters"))
        ulps, share = worst["y" if name.endswith("fwd") else "dx"]
        log(f"kernel {name} (N={n}, dim {dim}): {ulps:.2f} ulp (of the row's "
            f"largest) from plain at most, on {share:.3%} of the values; "
            f"bitwise repeatable; "
            f"{out[-1]['ms']:.3f} ms (plain "
            f"{out[-1]['plain_ms']:.3f}, F.layer_norm bf16 "
            f"{out[-1]['library_ms']:.3f}, bound {bnd:.3f} by {by})")
    return out


def rounded16(torch, y32, post):
    """bf16(bf16(y32) · bf16(post)) in torch's bf16 arithmetic: what a
    bf16-output form must give, bit for bit, from the same kernel's
    f32-output run with no post."""
    y = y32.to(torch.bfloat16)
    return y if post is None else y * post.to(torch.bfloat16)[:, None]


def near16(torch, got, want, what: str) -> dict:
    """Raise unless each value of the bf16 `got` lies within the larger of
    AGG_ULPS bf16 ulps of the bf16 `want` and AGG_ABS of max |want|, and at
    most AGG_SHARE of the values differ. Returns the most ulps off among the
    values the ulp bound holds (`ulps`), the most |got - want| / max |want|
    among those the absolute one holds (`abs_off`), and the share of values
    off (`off`)."""
    top = float(want.abs().max().float())
    floor = AGG_ABS * top
    ulps, abs_off, off, bad = 0.0, 0.0, 0, 0
    for a, b in zip(got.split(1 << 18), want.split(1 << 18)):
        a, b = a.float(), b.float()
        _, e = torch.frexp(b.abs().clamp_min(2.0 ** -120))   # m * 2^e
        ulp = torch.ldexp(torch.ones_like(b), e - 8)
        err = (a - b).abs()
        by_ulp = AGG_ULPS * ulp >= floor
        bad += int((err > torch.where(by_ulp, AGG_ULPS * ulp,
                                      torch.full_like(ulp, floor))).sum())
        rel, tiny = (err / ulp)[by_ulp], err[~by_ulp]
        if rel.numel():
            ulps = max(ulps, float(rel.max()))
        if tiny.numel():
            abs_off = max(abs_off, float(tiny.max()) / top)
        off += int((err > 0).sum())
    share = off / max(got.numel(), 1)
    if bad or share > AGG_SHARE:
        raise AssertionError(f"{what}: {bad} values beyond {AGG_ULPS} bf16 "
                             f"ulp and {AGG_ABS} of max |y| from the plain "
                             f"version (most {ulps} ulp, {abs_off:.3e} of "
                             f"max |y|), {share:.3e} of the values off "
                             f"(bound {AGG_SHARE})")
    return dict(ulps=ulps, abs_off=abs_off, off=share)


def near_text(r: dict) -> str:
    return (f"at most {r['ulps']:g} bf16 ulp off it where an ulp is at "
            f"least {AGG_ABS} of max |y| (bound {AGG_ULPS}), "
            f"{r['abs_off']:.3e} of max |y| elsewhere (bound {AGG_ABS}), "
            f"{r['off']:.3e} of the values off (bound {AGG_SHARE})")


def product16out_check(torch, kernel: str, g, inp, pre_f, post_f,
                       transpose: bool = False) -> dict:
    """The bf16-output form of an aggregation kernel ("csr_spmm" or
    "stream_spmm") on the graph's CSR (or its transpose), as the planner
    runs it on bf16 activations: the rows pre ⊙ x in bf16, no pre factor,
    the post factor in the kernel's bf16 epilogue. Bitwise equal to
    `rounded16` of the same kernel's f32-output run with no post, and
    across two runs (the stream kernel also with no hot set); timed beside
    the f32-output form on the same rows, the plain version, the bound and
    torch.sparse.mm on a bf16 CSR tensor; held to the plain version by
    `near16`."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
    from spgemm_gnn_tpu_torch.kernels.stream import stream_spmm, stream_spmm_at
    from spgemm_gnn_tpu_torch.ops.spmm import _scale, csr_spmm_plain
    from spgemm_gnn_tpu_torch.ops.stream import stream_spmm_plain

    bf16 = torch.bfloat16
    indptr = g.t_indptr if transpose else g.indptr
    indices = g.t_indices if transpose else g.indices
    rows = g.t_edge_dst if transpose else g.edge_dst
    n, e, dim = g.num_nodes, g.num_edges, inp.shape[1]
    x16 = _scale(inp.to(bf16), pre_f)
    if kernel == "stream_spmm":
        plan = build_stream_plan(indptr, indices)
        plan_bytes = (plan.num_chunks + plan.carry_rows.numel()) * 4
        run = stream_spmm

        def run_plain():
            return stream_spmm_plain(plan, x16, None, post_f, bf16)
    else:
        plan = CSRPlan(indptr, indices)
        plan_bytes = 0
        run = csr_spmm

        def run_plain():
            return csr_spmm_plain(indptr, indices, x16, None, post_f, bf16)

    got = run(plan, x16, None, post_f, out_dtype=bf16)
    again = run(plan, x16, None, post_f, out_dtype=bf16)
    want = rounded16(torch, run(plan, x16), post_f)
    torch.cuda.synchronize()
    if not bits_equal(torch, got, want):
        raise AssertionError(f"{kernel}_bf16_out differs from the rounding "
                             f"of its f32-output run")
    if not bits_equal(torch, got, again):
        raise AssertionError(f"{kernel}_bf16_out: two runs differ")
    del want, again
    extra = {}
    if kernel == "stream_spmm":
        def run_hot0():
            return stream_spmm_at(plan, x16, None, post_f, hot_budget=0,
                                  out_dtype=bf16)
        if not bits_equal(torch, got, run_hot0()):
            raise AssertionError("stream_spmm_bf16_out: hot budget 0 "
                                 "differs from the default")
        extra = hot_keys(plan.hot_set(2 * dim))
        extra["hot0_ms"] = time_ms(torch, run_hot0, 5)
    else:
        extra = dict(nb=plan.schedule(n, dim, 2).nb)
    plain = run_plain()
    err = float((got.float() - plain.float()).abs().max())
    near = near16(torch, got, plain, f"{kernel}_bf16_out")
    del plain
    w = torch.ones(e, device=inp.device)
    if post_f is not None:
        w = w * post_f[rows.long()]
    lib_ms, lib_err = library16(torch, indptr, indices, w, n, x16)
    del w
    gathered = torch.bincount(indices, minlength=n).double()
    ops = 2.0 * float(((x16 != 0).sum(1).double() * gathered).sum())
    n_bytes = (2 * n * dim * 2 + (n + 1) * 4 + e * 4 + plan_bytes
               + 4 * n * (post_f is not None))
    b_ms, b_by = bound_ms(n_bytes, ops)
    return dict(err=err, **near, bound_ms=b_ms, bound_by=b_by,
                ms=time_ms(torch, lambda: run(plan, x16, None, post_f,
                                              out_dtype=bf16), 5),
                f32_ms=time_ms(torch, lambda: run(plan, x16, None, post_f),
                               5),
                plain_ms=time_ms(torch, run_plain, 2),
                library_ms=lib_ms, library_error=lib_err,
                gather_ms=e * dim * 2 / PEAK_BYTES_S * 1e3, **extra)


def log_product16out(kernel: str, what: str, r: dict) -> None:
    lib = (f"{r['library_ms']:.3f}" if r["library_ms"] is not None
           else f"none ({r['library_error']})")
    log(f"kernel {kernel}_bf16_out ({what}): bitwise equal to bf16(bf16(y) "
        f"* bf16(post)) of its f32-output run, and across two runs; "
        f"{r['err']:.3e} max abs from the plain version, {near_text(r)}; "
        f"{r['ms']:.3f} ms "
        f"(f32-output form {r['f32_ms']:.3f}, plain {r['plain_ms']:.3f}, "
        f"torch.sparse.mm bf16 {lib}, bound {r['bound_ms']:.3f} by "
        f"{r['bound_by']}, no-reuse gather {r['gather_ms']:.3f})")
    if "hot0_ms" in r:
        log_hot(f"{what}, bf16 output", r)


def csr_cbsr16_check(torch, g, xs, post, out16: bool) -> dict:
    """csr_cbsr_spmm's form (`csr_cbsr_spmm_bf16`, or with `out16`
    `csr_cbsr_spmm_bf16_out`) on A of the windowed graph, on the records of
    the k-sparse input `xs` as the planner makes them (cbsr_compact, the
    values rounded to bf16; the mean factors have no pre), at the schedule
    of the dense bf16 form: bitwise equal to csr_spmm_bf16 (or _bf16_out)
    on the densified rows and across two runs; the f32 output within 1e-5
    of max |y| of the plain version in float64, the bf16 output the
    rounding of the f32 one and within 1 bf16 ulp of its plain version
    (`near16`); on integer values at the same
    channels, whose f32 sums are exact in any order, bit for bit its plain
    version (`ops/spmm.py::csr_cbsr_plain`). Timed beside the dense form on
    the same plan, the plain version and torch.sparse.mm bf16 on the
    densified rows; the bound counts the function's bytes (a record of the
    96 B it needs at k 32, `bf16_record_bytes`), and the 128-B layout's
    bound and no-reuse gather stand on their own keys."""
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    from spgemm_gnn_tpu_torch.kernels.cbsr import cbsr_compact
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_cbsr_spmm, csr_spmm
    from spgemm_gnn_tpu_torch.ops.maxk import cbsr_records, cbsr_to_dense
    from spgemm_gnn_tpu_torch.ops.spmm import csr_cbsr_plain, csr_spmm_plain

    bf16 = torch.bfloat16
    od = bf16 if out16 else None
    name = "csr_cbsr_spmm_bf16_out" if out16 else "csr_cbsr_spmm_bf16"
    n, e, dim = g.num_nodes, g.num_edges, xs.shape[1]
    vals, ch = cbsr_compact(xs, K)
    v16 = round_rows(vals)
    rec = cbsr_records(v16, ch, dim)
    dense = cbsr_to_dense(v16.float(), ch, dim).to(bf16)
    plan = CSRPlan(g.indptr, g.indices)
    sched = plan.schedule(n, dim, 2)

    def run(r=rec):
        return csr_cbsr_spmm(plan, r, K, dim, post, od)

    def run_dense():
        return csr_spmm(plan, dense, None, post, out_dtype=od)

    def run_plain(r=rec):
        return csr_cbsr_plain(sched.block_indptr, sched.indices, r, K, dim,
                              post, od)

    ints = (torch.randint(-4, 5, vals.shape, generator=torch.Generator(
        device="cuda").manual_seed(SEED + 5), device="cuda")).to(bf16)
    rec_int = cbsr_records(ints, ch, dim)
    got, again, by_dense = run(), run(), run_dense()
    got_int, plain_int = run(rec_int), run_plain(rec_int)
    torch.cuda.synchronize()
    ints16 = torch.int16 if out16 else torch.int32
    if not torch.equal(got.view(ints16), by_dense.view(ints16)):
        raise AssertionError(f"{name} differs from the dense form on the "
                             f"densified rows")
    if not torch.equal(got.view(ints16), again.view(ints16)):
        raise AssertionError(f"{name}: two runs differ")
    if not torch.equal(got_int.view(ints16), plain_int.view(ints16)):
        raise AssertionError(f"{name} differs from its plain version on "
                             f"integer values (exact sums)")
    del again, by_dense, got_int, plain_int, rec_int, ints
    plain = run_plain()
    if out16:
        f32 = csr_cbsr_spmm(plan, rec, K, dim)
        if not bits_equal(torch, got, rounded16(torch, f32, post)):
            raise AssertionError(f"{name} differs from the rounding of its "
                                 f"f32-output run")
        del f32
        err = float((got.float() - plain.float()).abs().max())
        extra = {NEAR_KEYS[key]: v for key, v in
                 near16(torch, got, plain, name).items()}
    else:
        ref = csr_spmm_plain(g.indptr, g.indices, dense.double(), None, post)
        err, rel = rel_err(got, ref)
        if not rel <= 1e-5:
            raise AssertionError(f"{name} error {rel:.3e} of max |y| > 1e-5")
        extra = dict(rel=rel)
        del ref
    del plain, got
    need, row = bf16_record_bytes(K), rec.shape[1] * 4
    gathered = torch.bincount(g.indices, minlength=n).double()
    ops = 2.0 * float(((dense != 0).sum(1).double() * gathered).sum())
    rest = e * 4 + (n + 1) * 4 + n * dim * (2 if out16 else 4) + 4 * n
    b_ms, b_by = bound_ms(n * need + rest, ops)
    layout_ms, _ = bound_ms(n * row + rest, ops)
    lib_ms, lib_err = library16(torch, g.indptr, g.indices,
                                post[g.edge_dst.long()], n, dense)
    r = dict(name=name, route="cuda",
             source="spgemm_gnn_tpu_torch/csrc/spmm.cu",
             replaces="spgemm_gnn_tpu/kernels/spgemm_pallas.py:97 on bf16 "
                      "rows (:124-129, :183-186" +
                      ("; bf16 output planned.py:271-274, :300" if out16
                       else "") +
                      ") composed with :285 _densify_t_kernel (call :329)",
             max_abs_err=err, ms=time_ms(torch, run, 10),
             dense_ms=time_ms(torch, run_dense, 10),
             plain_ms=time_ms(torch, run_plain, 2), bound_ms=b_ms,
             bound_by=b_by, library_ms=lib_ms, library_error=lib_err,
             layout_bound_ms=layout_ms, record_bytes=row, need_bytes=need,
             no_reuse_gather_ms=e * need / PEAK_BYTES_S * 1e3,
             layout_gather_ms=e * row / PEAK_BYTES_S * 1e3, nb=sched.nb,
             **extra)
    lib = (f"{lib_ms:.3f}" if lib_ms is not None else f"none ({lib_err})")
    near = (near_text(r | {key: r[NEAR_KEYS[key]] for key in NEAR_KEYS})
            if out16 else f"{r['rel']:.3e} of max |y| from float64")
    log(f"kernel {name} (reddit, A, k-sparse x, dim {dim}, k {K}, "
        f"{row}-B records, {sched.nb} source blocks, the dense form's "
        f"schedule): bitwise equal to the dense form on the densified rows, "
        f"across two runs and to its plain version on integer "
        f"values; {err:.3e} max abs from the plain version, {near}; "
        f"{r['ms']:.3f} ms (the dense form {r['dense_ms']:.3f}, plain "
        f"{r['plain_ms']:.3f}, torch.sparse.mm bf16 {lib}; bound {b_ms:.3f} "
        f"by {b_by} and no-reuse gather {r['no_reuse_gather_ms']:.3f} on the "
        f"{need} B a record needs)")
    log(f"  {name}: the {row}-B layout's bound {layout_ms:.3f} ms and "
        f"no-reuse gather {r['layout_gather_ms']:.3f} ms")
    return r


def stream_cbsr16out_check(torch, g, dim: int, k: int, seed: int) -> dict:
    """stream_cbsr_spmm_bf16_out on A of the graph at (dim, k) under the
    mean and gcn factors, as the planner runs it on bf16 activations: the
    bf16 rows pre ⊙ x compacted by cbsr_compact_bf16 into 128-B records.
    Bitwise equal to `rounded16` of the f32-output run with no post, across
    two runs, with no hot set and to stream_spmm_bf16_out on the same rows;
    timed beside the f32-output form, the plain version, the bound and the
    no-reuse gathers as in stream_cbsr16_check, and torch.sparse.mm on a
    bf16 CSR tensor, with `cbsr16_diagnosis`; held to
    the plain version by `near16`. Returns the kernels-line entry (mean
    factors; gcn under prefixed keys)."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.kernels.cbsr import cbsr_compact
    from spgemm_gnn_tpu_torch.kernels.stream import (stream_cbsr_spmm,
                                                     stream_cbsr_spmm_at,
                                                     stream_spmm)
    from spgemm_gnn_tpu_torch.ops.maxk import cbsr_records
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.spmm import _scale
    from spgemm_gnn_tpu_torch.ops.stream import stream_cbsr_spmm_plain

    bf16 = torch.bfloat16
    n, e = g.num_nodes, g.num_edges
    plan = build_stream_plan(g.indptr, g.indices)
    gen = torch.Generator(device="cuda").manual_seed(seed + 3)
    xs = sparse_input(torch, n, dim, k, gen).to(bf16)
    entry = dict(name="stream_cbsr_spmm_bf16_out", route="cuda",
                 source="spgemm_gnn_tpu_torch/csrc/stream.cu",
                 replaces="spgemm_gnn_tpu/kernels/stream_pallas.py:90 "
                          "(bf16 output, :192)")
    for norm in ("mean", "gcn"):
        pre, post = node_factors(g, norm)
        xin = _scale(xs, pre)
        vals, ch = cbsr_compact(xin, k)
        rec = cbsr_records(vals, ch, dim)
        del vals, ch

        def run():
            return stream_cbsr_spmm(plan, rec, k, dim, None, post, bf16, bf16)

        got, again = run(), run()
        want = rounded16(torch, stream_cbsr_spmm(plan, rec, k, dim, None,
                                                 None, bf16), post)
        by_b3 = stream_spmm(plan, xin, None, post, out_dtype=bf16)
        torch.cuda.synchronize()
        if not bits_equal(torch, got, want):
            raise AssertionError(f"stream_cbsr_spmm_bf16_out ({norm}) "
                                 f"differs from the rounding of its "
                                 f"f32-output run")
        if not torch.equal(got.view(torch.int16), by_b3.view(torch.int16)):
            raise AssertionError(f"stream_cbsr_spmm_bf16_out ({norm}) "
                                 f"differs from stream_spmm_bf16_out in "
                                 f"its bits")
        if not bits_equal(torch, got, again):
            raise AssertionError(f"stream_cbsr_spmm_bf16_out ({norm}): two "
                                 f"runs differ")

        def run_hot0():
            return stream_cbsr_spmm_at(plan, rec, k, dim, None, post,
                                       hot_budget=0, value_dtype=bf16,
                                       out_dtype=bf16)
        if not bits_equal(torch, got, run_hot0()):
            raise AssertionError(f"stream_cbsr_spmm_bf16_out ({norm}): hot "
                                 f"budget 0 differs from the default")
        del want, again, by_b3
        plain = stream_cbsr_spmm_plain(plan, rec, k, dim, None, post, bf16,
                                       bf16)
        err = float((got.float() - plain.float()).abs().max())
        near = near16(torch, got, plain,
                      f"stream_cbsr_spmm_bf16_out ({norm})")
        del plain
        row, need = rec.shape[1] * 4, bf16_record_bytes(k)
        lib_ms, lib_err = library16(torch, g.indptr, g.indices,
                                    post[g.edge_dst.long()], n, xin)
        gathered = torch.bincount(g.indices, minlength=n).double()
        ops = 2.0 * float(((xin != 0).sum(1).double() * gathered).sum())
        n_bytes = (n * need + e * 4 + (n + 1) * 4 + n * dim * 2
                   + (plan.num_chunks + plan.carry_rows.numel()) * 4 + 4 * n)
        b_ms, b_by = bound_ms(n_bytes, ops)
        r = dict(max_abs_err=err, **near, ms=time_ms(torch, run, 10),
                 f32_ms=time_ms(torch, lambda: stream_cbsr_spmm(
                     plan, rec, k, dim, None, post, bf16), 10),
                 plain_ms=time_ms(torch, lambda: stream_cbsr_spmm_plain(
                     plan, rec, k, dim, None, post, bf16, bf16), 2),
                 library_ms=lib_ms, library_error=lib_err,
                 hot0_ms=time_ms(torch, run_hot0, 10),
                 **hot_keys(plan.hot_set(row)), record_bytes=row,
                 need_bytes=need, bound_ms=b_ms, bound_by=b_by,
                 no_reuse_gather_ms=e * (need + 4) / PEAK_BYTES_S * 1e3,
                 layout_gather_ms=e * (row + 4) / PEAK_BYTES_S * 1e3)
        if norm == "mean":
            r.update(cbsr16_diagnosis(torch, plan, rec, k, dim, post, True))
        del rec, xin
        lib = (f"{lib_ms:.3f}" if lib_ms is not None else f"none ({lib_err})")
        log(f"kernel stream_cbsr_spmm_bf16_out (products, A, {norm} factors, "
            f"dim {dim}, k {k}, {row}-B records): bitwise equal to the "
            f"rounding of its f32-output run, across two runs and with no "
            f"hot set; bitwise equal to stream_spmm_bf16_out; {err:.3e} max "
            f"abs from the plain version, {near_text(near)}; "
            f"{r['ms']:.3f} ms (f32-output form "
            f"{r['f32_ms']:.3f}, plain {r['plain_ms']:.3f}, torch.sparse.mm "
            f"bf16 {lib}, bound {b_ms:.3f} by {b_by} and no-reuse gather "
            f"{r['no_reuse_gather_ms']:.3f} on the {need} B a record needs; "
            f"the {row}-B layout's no-reuse gather "
            f"{r['layout_gather_ms']:.3f})")
        log_hot(f"stream_cbsr_spmm_bf16_out, {norm} factors", r)
        if norm == "mean":
            log_diagnosis("stream_cbsr_spmm_bf16_out", r)
            entry.update({key: r[key] for key in (
                "max_abs_err", "ms", "f32_ms", "plain_ms", "bound_ms",
                "bound_by", "library_ms", "library_error", "record_bytes",
                "need_bytes", "no_reuse_gather_ms", "layout_gather_ms",
                *HOT_KEYS, *DIAG_KEYS)})
            entry.update({NEAR_KEYS[key]: r[key] for key in NEAR_KEYS})
        else:
            entry.update({f"gcn_{key}": r[key] for key in (
                "max_abs_err", "ms", "f32_ms", "bound_ms", "hot0_ms")})
            entry.update({f"gcn_{NEAR_KEYS[key]}": r[key]
                          for key in NEAR_KEYS})
    return entry


def sspmm16_check(torch, g, dim: int, k: int, seed: int) -> list[dict]:
    """B3's 16-bit forms on MaxK's backward (the sampled backward):
    stream_sspmm_bf16 and stream_sspmm_bf16_out on Aᵀ of the graph at (dim,
    k), as the planner runs them on the messages of the bf16x2 stream
    (round_rows(g, dst_f), f32 out) and of the 16-bit model (dst_f ⊙ g in
    bf16, bf16 out), with the channels that maxk_fwd keeps on seeded rows
    (rows with kept zeros among them), under the mean and gcn factors.
    First maxk_fwd with ids: y and meta those of the form without, the ids
    those of the plain version, f32 and bf16 rows, timed beside the form
    without (the way this port takes MaxK's channels). Then each form
    bitwise equal to the dense form (stream_spmm_bf16 / _out) at the kept
    channels and 0 elsewhere, across two runs and to the k-channel gather
    probe; within 1e-5 of max |y| (f32 out) or 1 bf16 ulp (bf16 out,
    `near16`) of the plain version (with a post factor, the bf16 output
    bitwise bf16(bf16(Σ) · bf16(post)) of the f32-output form's sums Σ,
    and bf16(Σ) within 1 ulp of the plain version's: two roundings can
    move a last-bit difference of Σ by two ulps); timed with each pass
    alone, beside the
    dense form and maxk_bwd after it, the gather probe, the plain version,
    the bound and no-reuse gather on the 2k bytes an edge needs, and the
    nearest library pair, torch.sparse.mm then torch.gather (no one call
    computes the function). Returns the two kernels-line entries (mean
    factors; gcn under prefixed keys)."""
    from spgemm_gnn_tpu_torch.graphs.stream_tiles import build_stream_plan
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_bwd, maxk_fwd
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.stream import (stream_ksample_at,
                                                     stream_spmm,
                                                     stream_sspmm,
                                                     stream_sspmm_at)
    from spgemm_gnn_tpu_torch.ops.maxk import maxk_channel_ids
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.spmm import _scale
    from spgemm_gnn_tpu_torch.ops.stream import stream_sspmm_plain

    bf16 = torch.bfloat16
    dev = g.indptr.device
    n, e = g.num_nodes, g.num_edges
    fwd = build_stream_plan(g.indptr, g.indices)
    plan = build_stream_plan(g.t_indptr, g.t_indices)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    perm = plan.transpose_positions(fwd)
    torch.cuda.synchronize()
    perm_s = time.perf_counter() - t0
    log(f"sampled backward: transpose positions of products' {e} edges "
        f"built in {perm_s:.2f} s ({perm.numel() * 4 / 2**30:.2f} GiB)")

    # MaxK's kept channels, from the forward itself
    x, gy = seeded_rows(torch, n, dim, k, seed + 5, dev)
    ids_ms = {}
    for xd in (x, x.to(bf16)):
        y0, meta0 = maxk_fwd(xd, k)
        y, meta, ids = maxk_fwd(xd, k, with_ids=True)
        torch.cuda.synchronize()
        what = "maxk_fwd_bf16" if xd.dtype == bf16 else "maxk_fwd"
        if not (equal_nan(torch, y, y0) and bits_equal(torch, meta, meta0)):
            raise AssertionError(f"{what} with ids: y or meta differ from "
                                 f"the form without")
        if not torch.equal(ids, maxk_channel_ids(xd, meta, k)):
            raise AssertionError(f"{what} with ids: ids differ from the "
                                 f"plain version")
        kept_zero = int((torch.gather(xd, 1, ids.long()) == 0).any(1).sum())
        ids_ms[what] = (time_ms(torch, lambda: maxk_fwd(xd, k, True), 20),
                        time_ms(torch, lambda: maxk_fwd(xd, k), 20))
        log(f"kernel {what} with ids (products, N={n} dim={dim} k={k}): y "
            f"and meta bitwise the form without, ids bitwise the plain "
            f"version ({kept_zero} rows keep a zero); "
            f"{ids_ms[what][0]:.3f} ms with ids, {ids_ms[what][1]:.3f} "
            f"without")
        del y0, meta0, y
    ch = ids   # the bf16 rows' kept channels
    h16 = x.to(bf16)
    del x
    keep = torch.zeros((n, dim), dtype=torch.bool, device=dev)
    keep.scatter_(1, ch.long(), True)
    kept_zero = int((torch.gather(h16, 1, ch.long()) == 0).any(1).sum())
    if not kept_zero:
        raise AssertionError("sampled backward: no seeded row keeps a zero")

    entries = []
    for out16 in (False, True):
        od = bf16 if out16 else None
        name = "stream_sspmm_bf16_out" if out16 else "stream_sspmm_bf16"
        entry = dict(
            name=name, route="cuda",
            source="spgemm_gnn_tpu_torch/csrc/stream.cu",
            replaces="spgemm_gnn_tpu/kernels/planned.py:233 sspmm_backward "
                     "= stream_pallas.py:37 (bf16 stream :227-228"
                     + (", out_dtype :217-242" if out16 else "")
                     + ") then spgemm_pallas.py:385 sample_channels",
            perm_build_s=perm_s,
            maxk_fwd_ids_ms=ids_ms["maxk_fwd_bf16" if out16
                                   else "maxk_fwd"][0],
            maxk_fwd_no_ids_ms=ids_ms["maxk_fwd_bf16" if out16
                                      else "maxk_fwd"][1])
        for norm in ("mean", "gcn"):
            src_f, dst_f = node_factors(g, norm)
            m = (_scale(gy.to(bf16), dst_f).contiguous() if out16
                 else round_rows(gy, dst_f))

            def run():
                return stream_sspmm(plan, fwd, m, ch, src_f, od)

            got, again = run(), run()
            dense = stream_spmm(plan, m, None, src_f, out_dtype=od)
            want = torch.where(keep, dense, torch.zeros(
                (), dtype=dense.dtype, device=dev))
            probe = stream_ksample_at(plan, m, ch, g.t_edge_dst, src_f,
                                      out_dtype=od)
            torch.cuda.synchronize()
            ints = torch.int16 if out16 else torch.int32
            for other, against in ((want, "the dense form masked to the "
                                    "kept channels"),
                                   (again, "a second run"),
                                   (probe, "the k-channel gather probe")):
                if not torch.equal(got.view(ints), other.view(ints)):
                    raise AssertionError(f"{name} ({norm}) differs from "
                                         f"{against} in its bits")
            del want, again, probe
            if out16 and src_f is not None:
                # bf16(bf16(Σ) · bf16(post)) rounds twice: a last-bit
                # difference of the plain version's f32 sums (summed in
                # another order) can move the second rounding by one more
                # ulp. So the bf16 output is held bitwise to the rounding
                # of the f32-output form's sums, and the rounding of the
                # sums alone (no post) to the plain version's
                sums = stream_sspmm(plan, fwd, m, ch, None)
                if not torch.equal(got.view(ints), rounded16(
                        torch, sums, src_f).view(ints)):
                    raise AssertionError(f"{name} ({norm}) differs from "
                                         f"bf16(bf16(Σ) · bf16(post)) of "
                                         f"its f32-output form's sums")
                del sums
                got = stream_sspmm(plan, fwd, m, ch, None, od)
                plain = stream_sspmm_plain(plan, m, ch, None, od)
            else:
                plain = stream_sspmm_plain(plan, m, ch, src_f, od)
            err = float((got.float() - plain.float()).abs().max())
            if out16:
                near = near16(torch, got, plain, f"{name} ({norm})")
            else:
                top = float(plain.abs().max())
                if not err <= 1e-5 * top:
                    raise AssertionError(f"{name} ({norm}): {err:.3e} from "
                                         f"the plain version, above 1e-5 "
                                         f"of max |y| {top:.3e}")
                near = {}
            del plain, got
            slots = stream_sspmm_at(plan, fwd, m, ch, passes=(1,))
            mk_x = h16 if out16 else h16.float()
            w = torch.ones(e, device=dev) if src_f is None else src_f[
                g.t_edge_dst.long()]
            a = torch.sparse_csr_tensor(g.t_indptr, g.t_indices, w.to(bf16),
                                        size=(n, n))
            chl = ch.long()

            def library():
                return torch.gather(torch.sparse.mm(a, m), 1, chl)
            try:
                library()
                torch.cuda.synchronize()
                lib_ms, lib_err = time_ms(torch, library, 5), None
            except (RuntimeError, NotImplementedError) as exc:
                lib_ms = None
                lib_err = (f"{type(exc).__name__}: "
                           f"{str(exc).splitlines()[0][:160]}")
            del a
            out_bytes = n * dim * (2 if out16 else 4)
            n_bytes = (n * dim * 2 + n * k + e * 4 + (n + 1) * 4 + out_bytes
                       + (0 if src_f is None else n * 4))
            b_ms, b_by = bound_ms(n_bytes, float(e) * k)
            r = dict(
                max_abs_err=err, **near, ms=time_ms(torch, run, 10),
                pass1_ms=time_ms(torch, lambda: stream_sspmm_at(
                    plan, fwd, m, ch, passes=(1,), slots=slots), 10),
                pass2_ms=time_ms(torch, lambda: stream_sspmm_at(
                    plan, fwd, m, ch, src_f, out_dtype=od, passes=(2,),
                    slots=slots), 10),
                gather_form_ms=time_ms(torch, lambda: stream_ksample_at(
                    plan, m, ch, g.t_edge_dst, src_f, out_dtype=od), 10),
                dense_ms=time_ms(torch, lambda: stream_spmm(
                    plan, m, None, src_f, out_dtype=od), 10),
                maxk_bwd_ms=time_ms(torch, lambda: maxk_bwd(
                    mk_x, meta, dense), 10),
                plain_ms=time_ms(torch, lambda: stream_sspmm_plain(
                    plan, m, ch, src_f, od), 2),
                library_ms=lib_ms, library_error=lib_err, bound_ms=b_ms,
                bound_by=b_by,
                no_reuse_gather_ms=e * 2 * k / PEAK_BYTES_S * 1e3,
                dense_gather_ms=e * 2 * dim / PEAK_BYTES_S * 1e3)
            r["dense_maxk_bwd_ms"] = r["dense_ms"] + r["maxk_bwd_ms"]
            del slots, dense, m, mk_x
            torch.cuda.empty_cache()
            lib = (f"{lib_ms:.3f}" if lib_ms is not None
                   else f"none ({lib_err})")
            log(f"kernel {name} (products, A^T, {norm} factors, dim {dim}, "
                f"k {k}, MaxK's channels, {kept_zero} rows keep a zero): "
                f"bitwise equal to the dense form at the kept channels and "
                f"0 elsewhere, across two runs and to the gather probe; "
                f"{err:.3e} max abs from the plain version"
                + (f", {near_text(near)}" if out16 else "") + "; "
                f"{r['ms']:.3f} ms (pass 1 {r['pass1_ms']:.3f}, pass 2 "
                f"{r['pass2_ms']:.3f}; dense form {r['dense_ms']:.3f} and "
                f"maxk_bwd{'_bf16' if out16 else ''} after it "
                f"{r['maxk_bwd_ms']:.3f}; gather form "
                f"{r['gather_form_ms']:.3f}; plain {r['plain_ms']:.3f}; "
                f"torch.sparse.mm then torch.gather {lib}; bound "
                f"{b_ms:.3f} by {b_by}; no-reuse gather {2 * k} B an edge "
                f"{r['no_reuse_gather_ms']:.3f}, {2 * dim} B "
                f"{r['dense_gather_ms']:.3f})")
            keys = ("max_abs_err", "ms", "pass1_ms", "pass2_ms",
                    "gather_form_ms", "dense_ms", "maxk_bwd_ms",
                    "dense_maxk_bwd_ms", "plain_ms", "library_ms",
                    "library_error", "bound_ms", "bound_by",
                    "no_reuse_gather_ms", "dense_gather_ms")
            if norm == "mean":
                entry.update({key: r[key] for key in keys})
                entry.update({NEAR_KEYS[key]: r[key] for key in NEAR_KEYS
                              if key in r})
            else:
                entry.update({f"gcn_{key}": r[key] for key in (
                    "max_abs_err", "ms", "dense_ms", "bound_ms")})
        entries.append(entry)
    del perm, keep, ch, h16, gy, meta
    plan._hot.clear()
    return entries


def csr_sspmm16_check(torch, g, dim: int, k: int, seed: int) -> list[dict]:
    """B2's 16-bit forms on MaxK's backward on a windowed plan (the sampled
    backward on B2's schedule): csr_sspmm_bf16 and csr_sspmm_bf16_out on
    Aᵀ of the Reddit graph at (dim, k), as the planner runs them on the
    messages of the bf16x2 stream (round_rows(g, dst_f), f32 out) and of
    the 16-bit model (dst_f ⊙ g in bf16, bf16 out), at the channels that
    maxk_fwd keeps on seeded rows (rows with kept zeros among them), under
    the mean and gcn factors. First maxk_fwd with ids at Reddit's shape,
    timed beside the form without (what the ids cost the forward). Then
    each form bitwise equal to the dense form (csr_spmm_bf16 / _out) at the
    kept channels and 0 elsewhere and across two runs; within 1e-5 of max
    |y| (f32 out) or 1 bf16 ulp (bf16 out, `near16`) of the plain version
    (with a post factor the bf16 output bitwise bf16(bf16(Σ) · bf16(post))
    of the f32-output form's sums Σ, and bf16(Σ) within 1 ulp of the plain
    version's); on integer messages, whose f32 sums are exact in any order,
    bitwise its plain version. Timed beside the dense form and maxk_bwd
    after it, the plain version, the bound, the no-reuse gathers of the 2k
    bytes an edge needs and of the 512-B row, and the nearest library
    pair, torch.sparse.mm then torch.gather. Returns the two kernels-line
    entries (mean factors; gcn under prefixed keys)."""
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    from spgemm_gnn_tpu_torch.kernels.maxk import maxk_bwd, maxk_fwd
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm, csr_sspmm
    from spgemm_gnn_tpu_torch.ops.maxk import maxk_channel_ids
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.spmm import _scale, csr_sspmm_plain

    bf16 = torch.bfloat16
    dev = g.indptr.device
    n, e = g.num_nodes, g.num_edges
    plan = CSRPlan(g.t_indptr, g.t_indices)
    sched = plan.schedule(n, dim, 2)
    x, gy = seeded_rows(torch, n, dim, k, seed + 7, dev)
    ids_ms = {}
    for xd in (x, x.to(bf16)):
        y0, meta0 = maxk_fwd(xd, k)
        y, meta, ids = maxk_fwd(xd, k, with_ids=True)
        what = "maxk_fwd_bf16" if xd.dtype == bf16 else "maxk_fwd"
        if not (equal_nan(torch, y, y0) and bits_equal(torch, meta, meta0)
                and torch.equal(ids, maxk_channel_ids(xd, meta, k))):
            raise AssertionError(f"{what} with ids (reddit): y, meta or ids "
                                 f"differ")
        ids_ms[what] = (time_ms(torch, lambda: maxk_fwd(xd, k, True), 20),
                        time_ms(torch, lambda: maxk_fwd(xd, k), 20))
        log(f"kernel {what} with ids (reddit, N={n} dim={dim} k={k}): "
            f"{ids_ms[what][0]:.3f} ms with ids, {ids_ms[what][1]:.3f} "
            f"without")
        del y0, meta0, y
    ch = ids   # the bf16 rows' kept channels
    h16 = x.to(bf16)
    del x
    keep = torch.zeros((n, dim), dtype=torch.bool, device=dev)
    keep.scatter_(1, ch.long(), True)
    kept_zero = int((torch.gather(h16, 1, ch.long()) == 0).any(1).sum())
    if not kept_zero:
        raise AssertionError("csr_sspmm: no seeded row keeps a zero")
    gen = torch.Generator(device=dev).manual_seed(seed + 8)
    m_int = torch.randint(-4, 5, (n, dim), generator=gen,
                          device=dev).to(bf16)

    entries = []
    for out16 in (False, True):
        od = bf16 if out16 else None
        ints = torch.int16 if out16 else torch.int32
        name = "csr_sspmm_bf16_out" if out16 else "csr_sspmm_bf16"
        entry = dict(
            name=name, route="cuda",
            source="spgemm_gnn_tpu_torch/csrc/spmm.cu",
            replaces="spgemm_gnn_tpu/kernels/planned.py:233 sspmm_backward "
                     "= spgemm_pallas.py:97 on Aᵀ (packed branch :124-129, "
                     ":183-186" + ("; bf16 output planned.py:271-274, :300"
                                   if out16 else "")
                     + ") then spgemm_pallas.py:385 sample_channels",
            nb=sched.nb,
            maxk_fwd_ids_ms=ids_ms["maxk_fwd_bf16" if out16
                                   else "maxk_fwd"][0],
            maxk_fwd_no_ids_ms=ids_ms["maxk_fwd_bf16" if out16
                                      else "maxk_fwd"][1])
        got_int = csr_sspmm(plan, m_int, ch, None, od)
        if not torch.equal(got_int.view(ints), csr_sspmm_plain(
                sched.block_indptr, sched.indices, m_int, ch, None,
                od).view(ints)):
            raise AssertionError(f"{name} differs from its plain version on "
                                 f"integer messages (exact sums)")
        del got_int
        for norm in ("mean", "gcn"):
            src_f, dst_f = node_factors(g, norm)
            m = (_scale(gy.to(bf16), dst_f).contiguous() if out16
                 else round_rows(gy, dst_f))

            def run():
                return csr_sspmm(plan, m, ch, src_f, od)

            got, again = run(), run()
            dense = csr_spmm(plan, m, None, src_f, out_dtype=od)
            want = torch.where(keep, dense, torch.zeros(
                (), dtype=dense.dtype, device=dev))
            torch.cuda.synchronize()
            for other, against in ((want, "the dense form masked to the "
                                    "kept channels"), (again, "a second run")):
                if not torch.equal(got.view(ints), other.view(ints)):
                    raise AssertionError(f"{name} ({norm}) differs from "
                                         f"{against} in its bits")
            del want, again
            if out16 and src_f is not None:
                # two roundings: held bitwise to the rounding of the
                # f32-output form's sums, and those sums' rounding (no
                # post) within 1 ulp of the plain version's (as
                # sspmm16_check holds the stream form)
                sums = csr_sspmm(plan, m, ch, None)
                if not torch.equal(got.view(ints), rounded16(
                        torch, sums, src_f).view(ints)):
                    raise AssertionError(f"{name} ({norm}) differs from "
                                         f"bf16(bf16(Σ) · bf16(post)) of "
                                         f"its f32-output form's sums")
                del sums
                got = csr_sspmm(plan, m, ch, None, od)
                plain = csr_sspmm_plain(sched.block_indptr, sched.indices, m,
                                        ch, None, od)
            else:
                plain = csr_sspmm_plain(sched.block_indptr, sched.indices, m,
                                        ch, src_f, od)
            err = float((got.float() - plain.float()).abs().max())
            if out16:
                near = near16(torch, got, plain, f"{name} ({norm})")
            else:
                top = float(plain.abs().max())
                if not err <= 1e-5 * top:
                    raise AssertionError(f"{name} ({norm}): {err:.3e} from "
                                         f"the plain version, above 1e-5 "
                                         f"of max |y| {top:.3e}")
                near = {}
            del plain, got
            mk_x = h16 if out16 else h16.float()
            w = torch.ones(e, device=dev) if src_f is None else src_f[
                g.t_edge_dst.long()]
            a = torch.sparse_csr_tensor(g.t_indptr, g.t_indices, w.to(bf16),
                                        size=(n, n))
            chl = ch.long()

            def library():
                return torch.gather(torch.sparse.mm(a, m), 1, chl)
            try:
                library()
                torch.cuda.synchronize()
                lib_ms, lib_err = time_ms(torch, library, 5), None
            except (RuntimeError, NotImplementedError) as exc:
                lib_ms = None
                lib_err = (f"{type(exc).__name__}: "
                           f"{str(exc).splitlines()[0][:160]}")
            del a
            out_bytes = n * dim * (2 if out16 else 4)
            n_bytes = (n * dim * 2 + n * k + e * 4 + (n + 1) * 4 + out_bytes
                       + (0 if src_f is None else n * 4))
            b_ms, b_by = bound_ms(n_bytes, 2.0 * e * k)
            r = dict(
                max_abs_err=err, **near, ms=time_ms(torch, run, 10),
                dense_ms=time_ms(torch, lambda: csr_spmm(
                    plan, m, None, src_f, out_dtype=od), 10),
                maxk_bwd_ms=time_ms(torch, lambda: maxk_bwd(
                    mk_x, meta, dense), 10),
                plain_ms=time_ms(torch, lambda: csr_sspmm_plain(
                    sched.block_indptr, sched.indices, m, ch, src_f, od), 2),
                library_ms=lib_ms, library_error=lib_err, bound_ms=b_ms,
                bound_by=b_by,
                no_reuse_gather_ms=e * 2 * k / PEAK_BYTES_S * 1e3,
                dense_gather_ms=e * 2 * dim / PEAK_BYTES_S * 1e3)
            r["dense_maxk_bwd_ms"] = r["dense_ms"] + r["maxk_bwd_ms"]
            del dense, m, mk_x
            torch.cuda.empty_cache()
            lib = (f"{lib_ms:.3f}" if lib_ms is not None
                   else f"none ({lib_err})")
            log(f"kernel {name} (reddit, A^T, {sched.nb} source blocks, "
                f"{norm} factors, dim {dim}, k {k}, MaxK's channels, "
                f"{kept_zero} rows keep a zero): bitwise equal to the dense "
                f"form at the kept channels and 0 elsewhere, across two "
                f"runs and to its plain version on integer messages; "
                f"{err:.3e} max abs from the plain version"
                + (f", {near_text(near)}" if out16 else "") + "; "
                f"{r['ms']:.3f} ms (dense form {r['dense_ms']:.3f} and "
                f"maxk_bwd{'_bf16' if out16 else ''} after it "
                f"{r['maxk_bwd_ms']:.3f}; plain {r['plain_ms']:.3f}; "
                f"torch.sparse.mm then torch.gather {lib}; bound "
                f"{b_ms:.3f} by {b_by}; no-reuse gather {2 * k} B an edge "
                f"{r['no_reuse_gather_ms']:.3f}, {2 * dim} B "
                f"{r['dense_gather_ms']:.3f})")
            keys = ("max_abs_err", "ms", "dense_ms", "maxk_bwd_ms",
                    "dense_maxk_bwd_ms", "plain_ms", "library_ms",
                    "library_error", "bound_ms", "bound_by",
                    "no_reuse_gather_ms", "dense_gather_ms")
            if norm == "mean":
                entry.update({key: r[key] for key in keys})
                entry.update({NEAR_KEYS[key]: r[key] for key in NEAR_KEYS
                              if key in r})
            else:
                entry.update({f"gcn_{key}": r[key] for key in (
                    "max_abs_err", "ms", "dense_ms", "bound_ms")})
        entries.append(entry)
    del keep, ch, h16, gy, meta, m_int
    return entries


def accuracy_check(torch) -> dict:
    """The 80-epoch accuracy check of the reference's trajectory gate
    (TRAJ_r03.json's config): the Reddit stand-in at scale 0.02, SAGE MaxK
    k 32, 3 x 256, LayerNorm, dropout 0, lr 0.01, seed 97, through the
    port's Trainer with the f32 and the bf16x2 stream, and with the 16-bit
    model (`--dtype bfloat16`). Each best test accuracy
    (best-val-selects-test) within 0.03 of the JAX oracle's from the same
    initial weights in the same dtype (ACC_ORACLE, ACC_ORACLE16), and each
    16-bit run within 0.03 of f32; the distance to TRAJ_r03.json's 0.849
    (the f32 oracle from the JAX package's own draw) is printed beside
    it."""
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    best = {}
    oracle = {"f32": ACC_ORACLE, "bf16x2": ACC_ORACLE,
              "bfloat16": ACC_ORACLE16}
    for run in oracle:
        cfg = TrainConfig(dataset="reddit", model="sage", nonlinear="maxk",
                          maxk=K, hidden_dim=HIDDEN, hidden_layers=3,
                          norm=True, dropout=0.0, w_lr=0.01,
                          epochs=ACC_EPOCHS, eval_every=1, log_every=0,
                          seed=SEED, device="cuda", impl="auto",
                          synthetic=True, synthetic_scale=ACC_SCALE,
                          stream="bf16x2" if run == "bf16x2" else "f32",
                          dtype="bfloat16" if run == "bfloat16"
                          else "float32")
        res = Trainer(cfg).run()
        best[run] = res["best_test_accuracy"]
        log(f"accuracy ({run}): best test {best[run]:.4f} at epoch "
            f"{res['best_epoch']} (val {res['best_val_accuracy']:.4f}), last "
            f"loss {res['history'][-1].loss:.6f}, steady epoch "
            f"{res['steady_epoch_s']}")
    for run, acc in best.items():
        if not abs(acc - oracle[run]) <= ACC_TOL:
            raise AssertionError(f"accuracy ({run}): best test {acc:.4f} is "
                                 f"not within {ACC_TOL} of the oracle's "
                                 f"{oracle[run]} from the same initial "
                                 f"weights")
        if not abs(acc - best["f32"]) <= ACC_TOL:
            raise AssertionError(f"accuracy: {run} {acc:.4f} is not within "
                                 f"{ACC_TOL} of f32 {best['f32']:.4f}")
    log(f"accuracy check ({ACC_EPOCHS} epochs, reddit stand-in scale "
        f"{ACC_SCALE}): best test f32 {best['f32']:.4f}, bf16x2 "
        f"{best['bf16x2']:.4f}, bfloat16 {best['bfloat16']:.4f}; each "
        f"within {ACC_TOL} of the JAX oracle's from the same initial "
        f"weights ({ACC_ORACLE} f32, {ACC_ORACLE16} bf16), and of f32; "
        f"from TRAJ_r03.json's {ACC_TRAJ_R03} (other initial weights): "
        f"{best['f32'] - ACC_TRAJ_R03:+.4f} f32, "
        f"{best['bf16x2'] - ACC_TRAJ_R03:+.4f} bf16x2, "
        f"{best['bfloat16'] - ACC_TRAJ_R03:+.4f} bfloat16")
    return best


def run_training(torch, trainer, expected: dict, what: str,
                 epochs: int = EPOCHS) -> dict:
    """Trainer.run from zeroed launch counts; checks `epochs` finite losses
    and the exact counts. Returns the run's result and counts."""
    from spgemm_gnn_tpu_torch.kernels import _build
    resident = torch.cuda.memory_allocated() / 2**30
    torch.cuda.reset_peak_memory_stats()
    _build.launches.clear()
    res = trainer.run()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    losses = [r.loss for r in res["history"]]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"{what}: losses {losses}")
    log(f"{what}: val acc {[r.val_acc for r in res['history']]}")
    log(f"{what}: steady_epoch_s {res['steady_epoch_s']}, wall "
        f"{res['wall_time_s']:.2f} s, peak memory {peak:.2f} GiB ("
        f"{resident:.2f} resident at its start), allocator "
        f"retries {torch.cuda.memory_stats()['num_alloc_retries']}")
    if len(losses) != epochs or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{what}: losses not finite: {losses}")
    if counts != expected:
        raise AssertionError(f"{what}: launch counts {counts} != expected "
                             f"{expected}")
    log(f"{what}: launches {counts}")
    return dict(res=res, losses=losses, counts=counts, peak_gib=peak,
                resident_gib=resident)


def same_losses(run: dict, off: dict, what: str) -> None:
    """The default rule's losses within 1e-6 relative of the flag-off
    run's; logs whether they are bit-equal."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(run["losses"],
                                                   off["losses"]))
    if not rel <= 1e-6:
        raise AssertionError(f"{what}: default losses {run['losses']} vs "
                             f"flag-off {off['losses']} ({rel:.3e})")
    same = run["losses"] == off["losses"]
    log(f"{what}: the default against the flag off: losses "
        f"{'bit-equal' if same else f'within {rel:.3e} relative'}")


def bit_equal_losses(run: dict, dense: dict, what: str) -> None:
    """The default's losses bit-equal to those of the run with
    SAMPLED_BACKWARD off: the sampled backward gives the dense backward's
    bits wherever MaxK's backward keeps them."""
    if run["losses"] != dense["losses"]:
        raise AssertionError(f"{what}: default losses {run['losses']} vs "
                             f"SAMPLED_BACKWARD off {dense['losses']}")
    log(f"{what}: the default against SAMPLED_BACKWARD off: losses "
        f"bit-equal")


def log_against_dense(what: str, run: dict, dense: dict,
                      off: dict | None = None) -> None:
    """Steady epochs and peak memory of the default beside the runs with
    SAMPLED_BACKWARD off (and STREAM_CBSR_FORWARD off) in this call."""
    line = (f"{what}: steady epoch {run['res']['steady_epoch_s']} s "
            f"default, {dense['res']['steady_epoch_s']} s SAMPLED_BACKWARD "
            f"off")
    if off is not None:
        line += (f", {off['res']['steady_epoch_s']} s STREAM_CBSR_FORWARD "
                 f"off")
    line += (f"; peak memory {run['peak_gib']:.2f} GiB default, "
             f"{dense['peak_gib']:.2f} SAMPLED_BACKWARD off")
    if off is not None:
        line += f", {off['peak_gib']:.2f} STREAM_CBSR_FORWARD off"
    log(line)


def require_fall(run: dict, what: str) -> None:
    """The last of a run's losses below its first."""
    if not run["losses"][-1] < run["losses"][0]:
        raise AssertionError(f"{what}: loss did not fall: {run['losses']}")


def first_steps(torch, cfg, ds, what: str) -> None:
    """The first two train steps through the kernels (impl auto, with
    STREAM_CBSR_FORWARD as the caller set it) against the plain ops (impl
    torch): the same weights and dropout seed, losses within 1e-4
    relative."""
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    first = {}
    for impl in ("auto", "torch"):     # the kernels, then the plain ops
        tr = Trainer(cfg.replace(impl=impl), dataset=ds)
        state = tr.init_state()
        drop = torch.Generator(device=tr.device).manual_seed(SEED + 1)
        first[impl] = [float(tr.train_step(state, drop)) for _ in range(2)]
        del tr, state
        torch.cuda.empty_cache()
    rel = [abs(a - b) / abs(b) for a, b in zip(first["auto"], first["torch"])]
    if not max(rel) <= 1e-4:
        raise AssertionError(f"{what}: first steps {first['auto']} vs plain "
                             f"{first['torch']} ({rel})")
    log(f"{what}: first two steps through the kernels {first['auto']}, "
        f"plain {first['torch']}, relative {rel}")


def cbsr_phase(torch, pg, dim: int, k: int, seed: int) -> list[dict]:
    """K5-K7 at the graph's node count, bitwise against their plain versions
    and timed; then the explicit CBSR path (compact → aggregate_cbsr forward
    and backward) through the kernels with its launches counted, held to the
    dense path."""
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.kernels import api
    from spgemm_gnn_tpu_torch.kernels.cbsr import (cbsr_compact, cbsr_densify,
                                                   cbsr_sample)
    from spgemm_gnn_tpu_torch.ops import maxk as plain

    n = pg.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(seed)
    xs = sparse_input(torch, n, dim, k, gen)
    z = torch.randn((n, dim), generator=gen, device="cuda")
    out = []

    vals, ch = cbsr_compact(xs, k)
    vals_p, ch_p = plain.cbsr_compact_plain(xs, k)
    dense = cbsr_densify(vals, ch, dim)
    sampled = cbsr_sample(z, ch)
    torch.cuda.synchronize()
    checks = (("cbsr_compact", (vals, ch), (vals_p, ch_p)),
              ("cbsr_densify", (dense,), (plain.cbsr_to_dense(vals, ch, dim),)),
              ("cbsr_sample", (sampled,), (plain.sample_channels(z, ch),)))
    errs = {}
    for name, got, want in checks:
        if not all(bits_equal(torch, a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name} differs from its plain version")
        # the channels' difference counts too (as ids, for cbsr_compact)
        errs[name] = max(float((a - b).abs().max()) for a, b in zip(got, want))
        log(f"kernel {name}: bitwise equal to plain, N={n} dim={dim} k={k}, "
            f"max abs err {errs[name]}")
    del vals_p, ch_p, checks
    ch_long = ch.long()
    nk = n * k * 4
    timings = (
        ("cbsr_compact", "spgemm_gnn_tpu/kernels/maxk_pallas.py:166",
         lambda: cbsr_compact(xs, k), lambda: plain.cbsr_compact_plain(xs, k),
         None, n * dim * 4 + 2 * nk),
        ("cbsr_densify", "spgemm_gnn_tpu/kernels/spgemm_pallas.py:340",
         lambda: cbsr_densify(vals, ch, dim),
         lambda: plain.cbsr_to_dense(vals, ch, dim),
         lambda: torch.zeros((n, dim), device="cuda").scatter_(1, ch_long,
                                                                vals),
         2 * nk + n * dim * 4),
        ("cbsr_sample", "spgemm_gnn_tpu/kernels/spgemm_pallas.py:385",
         lambda: cbsr_sample(z, ch), lambda: plain.sample_channels(z, ch),
         lambda: torch.gather(z, 1, ch_long), 3 * nk))
    for name, replaces, fn, fn_plain, fn_lib, n_bytes in timings:
        b, by = bound_ms(n_bytes, 0.0)
        out.append(dict(
            name=name, route="cuda", source="spgemm_gnn_tpu_torch/csrc/cbsr.cu",
            replaces=replaces, max_abs_err=errs[name],
            ms=time_ms(torch, fn, 10),
            plain_ms=time_ms(torch, fn_plain, 3), bound_ms=b, bound_by=by,
            library_ms=None if fn_lib is None else time_ms(torch, fn_lib, 10)))
        log(f"kernel {name}: {out[-1]['ms']:.3f} ms (plain "
            f"{out[-1]['plain_ms']:.3f}, library {out[-1]['library_ms']}, "
            f"bound {b:.3f} by {by})")
    out[1]["also_replaces"] = "spgemm_gnn_tpu/kernels/spgemm_pallas.py:285"
    del dense, sampled, z, ch_long

    # the explicit CBSR path, through the entry points a user calls, with
    # the dense forward (the flag off), then at the default rule
    from spgemm_gnn_tpu_torch.kernels import planned
    planned.STREAM_CBSR_FORWARD = False
    ct = torch.randn((n, dim), generator=gen, device="cuda")
    x_in = xs.clone().requires_grad_(True)
    _build.launches.clear()
    v, c = api.cbsr_compact(x_in, k, impl="cuda")
    v.retain_grad()
    y = api.aggregate_cbsr(pg, v, c, dim, "mean", impl="cuda")
    (y * ct).sum().backward()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    expected = {"cbsr_compact": 1, "cbsr_densify": 2, "cbsr_sample": 1,
                f"{'stream' if pg.kind == 'stream' else 'csr'}_spmm": 2}
    if counts != expected:
        raise AssertionError(f"CBSR path: launch counts {counts} != "
                             f"{expected}")
    log(f"CBSR path (cbsr_compact → aggregate_cbsr → backward): launches "
        f"{counts}")
    for entry in out:
        entry["launches"] = counts[entry["name"]]
        entry["launches_path"] = "cbsr"
    if not bits_equal(torch, x_in.grad, plain.cbsr_to_dense(v.grad, c, dim)):
        raise AssertionError("CBSR path: dx is not the densify of dvalues")
    xd = plain.cbsr_to_dense(v.detach(), c, dim).requires_grad_(True)
    y_ref = api.aggregate(pg, xd, "mean", impl="torch")
    (y_ref * ct).sum().backward()
    _, rel_y = rel_err(y.detach(), y_ref.detach())
    _, rel_dv = rel_err(v.grad, plain.sample_channels(xd.grad, c))
    if not (rel_y <= 1e-5 and rel_dv <= 1e-5):
        raise AssertionError(f"CBSR path against the dense path: y "
                             f"{rel_y:.3e}, dvalues {rel_dv:.3e} of max > 1e-5")
    log(f"CBSR path against the dense plain path: y {rel_y:.3e}, dvalues "
        f"{rel_dv:.3e} of max")
    del xd, y_ref

    # the same path at the default rule: the forward takes stream_cbsr_spmm
    # on (values, channels) and densifies nothing
    planned.STREAM_CBSR_FORWARD = None
    x_on = xs.clone().requires_grad_(True)
    _build.launches.clear()
    v_on, c_on = api.cbsr_compact(x_on, k, impl="cuda")
    v_on.retain_grad()
    y_on = api.aggregate_cbsr(pg, v_on, c_on, dim, "mean", impl="cuda")
    (y_on * ct).sum().backward()
    torch.cuda.synchronize()
    counts = dict(_build.launches)
    expected = {"cbsr_compact": 1, "stream_cbsr_spmm": 1, "stream_spmm": 1,
                "cbsr_sample": 1, "cbsr_densify": 1}
    if counts != expected:
        raise AssertionError(f"CBSR path, default rule: launch counts "
                             f"{counts} != {expected}")
    if not (torch.equal(y_on, y) and bits_equal(torch, v_on.grad, v.grad)
            and bits_equal(torch, x_on.grad, x_in.grad)):
        raise AssertionError("CBSR path, default rule: y or the gradients "
                             "differ from the flag-off path's")
    log(f"CBSR path at the default rule: launches {counts} (the "
        f"forward densifies nothing); y equal by value, dvalues and dx "
        f"bitwise equal to the flag-off path's, so within {rel_y:.3e} and "
        f"{rel_dv:.3e} of the dense plain path")
    return out


def bf16_near(torch, got, want) -> tuple[int, float, float]:
    """(values off by more than one bf16 ulp of `want`, the largest
    |got - want| among them, the largest over all values) of bf16 tensors;
    where an f32 sum cancels, an ulp lies below its summation-order error,
    so the caller holds the values beyond one ulp to 1e-5 of max |want|."""
    g, w = got.float(), want.float()
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126)))
                     - 7)
    off = (g - w).abs()
    far = off > ulp
    return (int(far.sum()), float(off[far].max()) if far.any() else 0.0,
            float(off.max()))


def cbsr16_phase(torch, pg, dim: int, k: int, seed: int,
                 f32: dict) -> list[dict]:
    """B4-B6 on bf16 at the graph's node count: cbsr_densify in its three
    new forms (bf16 -> bf16, bf16 -> f32, f32 -> bf16) and cbsr_sample_bf16,
    bitwise against their plain versions (the f32 -> bf16 form also against
    torch's own cast of the f32 densify) and timed beside their f32 form
    (`f32`: the cbsr_phase entries by name), the plain version, the bound
    and one library call. Then the bf16 CBSR path through the entry points,
    its launches counted exactly: compact on bf16 rows -> aggregate_cbsr
    forward and backward (dx bitwise the densify of dvalues; y within 1e-5
    of max |y| of the dense plain path on the widened values, dvalues
    within one bf16 ulp of its sampled gradient, 1e-5 of max where a sum
    cancels, on at most AGG_SHARE of the values), the bf16 dx sampled back
    at the channels (bitwise dvalues), and an f32 CBSR densified into bf16
    rows for a bf16 aggregation."""
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.kernels import api
    from spgemm_gnn_tpu_torch.kernels.cbsr import (cbsr_compact, cbsr_densify,
                                                   cbsr_sample, densify_name)
    from spgemm_gnn_tpu_torch.ops import maxk as plain

    bf16, f32t = torch.bfloat16, torch.float32
    n = pg.num_nodes
    gen = torch.Generator(device="cuda").manual_seed(seed + 16)
    xs = sparse_input(torch, n, dim, k, gen)
    vals, ch = cbsr_compact(xs, k)           # f32 values, off the bf16 grid
    vals16, ch16 = cbsr_compact(xs.to(bf16), k)
    z16 = torch.randn((n, dim), generator=gen, device="cuda").to(bf16)
    torch.cuda.synchronize()
    forms = (  # (name, values, channels, out dtype)
        (densify_name(bf16, bf16), vals16, ch16, bf16),
        (densify_name(bf16, f32t), vals16, ch16, f32t),
        (densify_name(f32t, bf16), vals, ch, bf16))
    errs = {}
    for name, v, c, out_dt in forms:
        got = cbsr_densify(v, c, dim, out_dt)
        want = plain.cbsr_to_dense(v, c, dim, out_dt)
        torch.cuda.synchronize()
        if not (got.dtype == out_dt and torch.equal(
                got.view(torch.int16 if out_dt == bf16 else torch.int32),
                want.view(torch.int16 if out_dt == bf16 else torch.int32))):
            raise AssertionError(f"{name} differs from its plain version")
        if out_dt == bf16 and v.dtype == f32t:
            cast = cbsr_densify(v, c, dim).to(bf16)
            if not torch.equal(got.view(torch.int16), cast.view(torch.int16)):
                raise AssertionError(f"{name}: not round-to-nearest-even "
                                     f"(torch's cast of the f32 densify)")
        errs[name] = float((got.float() - want.float()).abs().max())
        log(f"kernel {name}: bitwise equal to plain, N={n} dim={dim} k={k}, "
            f"max abs err {errs[name]}"
            + (", and to torch's cast of the f32 densify"
               if v.dtype == f32t else ""))
        del got, want
    sampled = cbsr_sample(z16, ch16)
    torch.cuda.synchronize()
    if not (sampled.dtype == bf16 and torch.equal(
            sampled.view(torch.int16),
            plain.sample_channels(z16, ch16).view(torch.int16))):
        raise AssertionError("cbsr_sample_bf16 differs from its plain "
                             "version")
    errs["cbsr_sample_bf16"] = float(
        (sampled.float() - plain.sample_channels(z16, ch16).float())
        .abs().max())
    log(f"kernel cbsr_sample_bf16: bitwise equal to plain, N={n} dim={dim} "
        f"k={k}, max abs err {errs['cbsr_sample_bf16']}")
    del sampled

    out = []
    nk = n * k
    ch_long, ch16_long = ch.long(), ch16.long()
    src = "spgemm_gnn_tpu_torch/csrc/cbsr.cu"
    dens = "spgemm_gnn_tpu/kernels/spgemm_pallas.py:340"
    timings = (  # name, replaces, f32 form, fn, plain, library, bytes
        (forms[0][0], dens, "cbsr_densify",
         lambda: cbsr_densify(vals16, ch16, dim, bf16),
         lambda: plain.cbsr_to_dense(vals16, ch16, dim, bf16),
         lambda: torch.zeros((n, dim), dtype=bf16, device="cuda").scatter_(
             1, ch16_long, vals16),
         nk * 2 + nk * 4 + n * dim * 2),
        (forms[1][0], dens, "cbsr_densify",
         lambda: cbsr_densify(vals16, ch16, dim, f32t),
         lambda: plain.cbsr_to_dense(vals16, ch16, dim, f32t),
         lambda: torch.zeros((n, dim), device="cuda").scatter_(
             1, ch16_long, vals16.float()),
         nk * 2 + nk * 4 + n * dim * 4),
        (forms[2][0], dens, "cbsr_densify",
         lambda: cbsr_densify(vals, ch, dim, bf16),
         lambda: plain.cbsr_to_dense(vals, ch, dim, bf16),
         lambda: torch.zeros((n, dim), dtype=bf16, device="cuda").scatter_(
             1, ch_long, vals.to(bf16)),
         nk * 4 + nk * 4 + n * dim * 2),
        ("cbsr_sample_bf16", "spgemm_gnn_tpu/kernels/spgemm_pallas.py:385",
         "cbsr_sample", lambda: cbsr_sample(z16, ch16),
         lambda: plain.sample_channels(z16, ch16),
         lambda: torch.gather(z16, 1, ch16_long), nk * 4 + 2 * nk * 2))
    for name, replaces, f32_name, fn, fn_plain, fn_lib, n_bytes in timings:
        b, by = bound_ms(n_bytes, 0.0)
        out.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            max_abs_err=errs[name], ms=time_ms(torch, fn, 10),
            plain_ms=time_ms(torch, fn_plain, 3), bound_ms=b, bound_by=by,
            library_ms=time_ms(torch, fn_lib, 10),
            f32_form_ms=f32[f32_name]["ms"]))
        log(f"kernel {name}: {out[-1]['ms']:.3f} ms (f32 form {f32_name} "
            f"{out[-1]['f32_form_ms']:.3f}, plain {out[-1]['plain_ms']:.3f}, "
            f"library {out[-1]['library_ms']:.3f}, bound {b:.3f} by {by})")
    for entry in out[:3]:
        entry["also_replaces"] = "spgemm_gnn_tpu/kernels/spgemm_pallas.py:285"
    del ch_long, ch16_long, z16

    # the bf16 CBSR path, through the entry points a user calls, with the
    # dense forward (the flag off: its densify forms are held here)
    from spgemm_gnn_tpu_torch.kernels import planned
    planned.STREAM_CBSR_FORWARD = False
    ct = torch.randn((n, dim), generator=gen, device="cuda")
    x_in = xs.to(bf16).requires_grad_(True)
    _build.launches.clear()
    v, c = api.cbsr_compact(x_in, k, impl="cuda")
    v.retain_grad()
    y = api.aggregate_cbsr(pg, v, c, dim, "mean", impl="cuda")
    (y * ct).sum().backward()
    dv_back = cbsr_sample(x_in.grad, c)
    x16 = cbsr_densify(vals, ch, dim, bf16)
    y16 = api.aggregate(pg, x16, "mean", impl="cuda")
    torch.cuda.synchronize()
    planned.STREAM_CBSR_FORWARD = None
    counts = dict(_build.launches)
    expected = {"cbsr_compact_bf16": 1, forms[1][0]: 1, "stream_spmm": 2,
                "cbsr_sample": 1, forms[0][0]: 1, "cbsr_sample_bf16": 1,
                forms[2][0]: 1, "stream_spmm_bf16_out": 1}
    if pg.kind != "stream" or counts != expected:
        raise AssertionError(f"CBSR bf16 path: launch counts {counts} != "
                             f"{expected}")
    log(f"CBSR bf16 path (cbsr_compact on bf16 rows -> aggregate_cbsr -> "
        f"backward; dx sampled back; an f32 CBSR densified into bf16 rows "
        f"-> aggregate): launches {counts}")
    for entry in out:
        entry["launches"] = counts[entry["name"]]
        entry["launches_path"] = "cbsr bf16"
    if not (y.dtype == f32t and v.grad.dtype == bf16
            and x_in.grad.dtype == bf16 and y16.dtype == bf16):
        raise AssertionError("CBSR bf16 path: dtypes")
    if not torch.equal(x_in.grad.view(torch.int16),
                       plain.cbsr_to_dense(v.grad, c, dim).view(torch.int16)):
        raise AssertionError("CBSR bf16 path: dx is not the densify of "
                             "dvalues")
    if not torch.equal(dv_back.view(torch.int16), v.grad.view(torch.int16)):
        raise AssertionError("CBSR bf16 path: dx sampled at the channels is "
                             "not dvalues")
    xd = plain.cbsr_to_dense(v.detach(), c, dim, f32t).requires_grad_(True)
    y_ref = api.aggregate(pg, xd, "mean", impl="torch")
    (y_ref * ct).sum().backward()
    _, rel_y = rel_err(y.detach(), y_ref.detach())
    dv_ref = plain.sample_channels(xd.grad, c).to(bf16)
    n_off, far_err, dv_err = bf16_near(torch, v.grad, dv_ref)
    dv_max = float(dv_ref.float().abs().max())
    if not (rel_y <= 1e-5 and far_err <= AGG_ABS * dv_max
            and n_off <= AGG_SHARE * dv_ref.numel()):
        raise AssertionError(f"CBSR bf16 path against the dense plain path: "
                             f"y {rel_y:.3e} of max, dvalues {n_off} off by "
                             f"more than one bf16 ulp, by up to "
                             f"{far_err / dv_max:.3e} of max")
    log(f"CBSR bf16 path against the dense plain path: y {rel_y:.3e} of max "
        f"|y|; dvalues max abs err "
        f"{dv_err:.3e} ({dv_err / dv_max:.3e} of max), off by more than one "
        f"bf16 ulp on {n_off} of {dv_ref.numel()}, by up to "
        f"{far_err / dv_max:.3e} of max (sums that cancel)")
    del xd, y_ref, x16, y16
    return out


def request_seeds(torch, test_ids, size: int, seed: int):
    """`size` distinct test nodes drawn with a seeded generator."""
    gen = torch.Generator().manual_seed(seed)
    return test_ids[torch.randperm(test_ids.numel(), generator=gen)[:size]]


def serve_phase(torch, cfg, ds, workdir: str) -> None:
    """The serving and persistence path on the products recipe (f32):
    checkpoints every 2 epochs of a 4-epoch run; a fresh Trainer resumed to
    6 epochs starts at epoch 4 and gives the losses of an uninterrupted
    6-epoch run bitwise (the checkpoint carries the dropout generator);
    `evaluate_checkpoint` of `best` (what --evaluate runs) equals that
    epoch's record; then predict requests of 1, 64 and 1024 test nodes
    through the device store and host stores of every policy at cache ratio
    0.05, each held to the full-graph eval forward at the restored weights
    (the stream plan's kernels) within 1e-4 of max |logit| but on rows that
    MaxK near-ties flip (at most 0.5 % of the seeds, argmax agreement on at
    least 99.5 %), with exact launch counts (maxk_fwd and csr_spmm once per
    layer, no stream_spmm), and the request's time split printed."""
    import os
    import numpy as np
    from spgemm_gnn_tpu_torch.graphs.features import (DeviceFeatureStore,
                                                      HostFeatureStore)
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.kernels.planned import graph_plans
    from spgemm_gnn_tpu_torch.train import checkpoint as ckpt
    from spgemm_gnn_tpu_torch.train.infer import (khop_in_subgraph,
                                                  predict_nodes)
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    layers = cfg.hidden_layers
    whole_dir = os.path.join(workdir, "whole")
    cut_dir = os.path.join(workdir, "cut")
    whole = Trainer(cfg.replace(epochs=6, checkpoint_every=2,
                                path=whole_dir), dataset=ds).run()
    Trainer(cfg.replace(epochs=4, checkpoint_every=2, path=cut_dir),
            dataset=ds).run()
    if ckpt.latest_step(cut_dir) != 4:
        raise AssertionError("serve: the 4-epoch run left no step-4 "
                             "checkpoint")
    tr = Trainer(cfg.replace(epochs=6, checkpoint_every=2, resume=True,
                             path=cut_dir), dataset=ds)
    resumed = tr.run()
    epochs = [r.epoch for r in resumed["history"]]
    if epochs != [4, 5] or resumed["history"] != whole["history"][4:]:
        raise AssertionError(f"serve: resumed records "
                             f"{resumed['history']} != uninterrupted "
                             f"{whole['history'][4:]}")
    log(f"serve: resumed at epoch 4 (epochs {epochs}); losses "
        f"{[r.loss for r in resumed['history']]} bit-equal to the "
        f"uninterrupted 6-epoch run's, val and test accuracies equal")
    best = {r.epoch: r for r in whole["history"]}[whole["best_epoch"]]
    best_dir = os.path.join(whole_dir, "checkpoints", "best")
    got = tr.evaluate_checkpoint(best_dir)
    if got != (best.train_acc, best.val_acc, best.test_acc):
        raise AssertionError(f"serve: --evaluate of best {got} != epoch "
                             f"{best.epoch}'s record {best}")
    log(f"serve: --evaluate (Trainer.evaluate_checkpoint) of best, epoch "
        f"{best.epoch}: {got}, equal to its record")

    # the restored best state serves the requests
    state = ckpt.restore_checkpoint(best_dir, tr.init_state())
    model = state["model"].eval()
    g = tr.graph
    with torch.no_grad():
        full = model(tr.g, tr.features)
    torch.cuda.synchronize()
    feats = ds.features
    stores = {"device": DeviceFeatureStore(tr.features, device="cuda")}
    for policy in ("direct", "static-outd", "fifo", "lru"):
        stores[policy] = HostFeatureStore(
            feats, policy=policy, cache_ratio=0.05,
            out_degrees=g.out_degrees, device="cuda")
    test_ids = torch.from_numpy(np.flatnonzero(ds.test_mask))
    for size in (1, 64, 1024):
        seeds = request_seeds(torch, test_ids, size, SEED + size).numpy()
        rows = np.unique(seeds)
        # the request's split, step by step as predict_nodes takes it
        hop_line = []
        for h in range(1, layers + 1):
            t0 = time.perf_counter()
            sub, nodes, _ = khop_in_subgraph(g, seeds, h)
            torch.cuda.synchronize()
            khop_ms = (time.perf_counter() - t0) * 1e3
            hop_line.append(f"hop {h}: {sub.num_nodes} nodes, "
                            f"{sub.num_edges} edges"
                            + (" (the whole graph)" if sub is g else ""))
        t0 = time.perf_counter()
        fwd, _ = graph_plans(sub)
        fwd.schedule(sub.num_nodes, cfg.hidden_dim, 4)
        torch.cuda.synchronize()
        sched_ms = (time.perf_counter() - t0) * 1e3
        x = stores["device"].fetch(nodes)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            model(sub, x)
        torch.cuda.synchronize()
        fwd_ms = (time.perf_counter() - t0) * 1e3
        log(f"serve request of {size}: {'; '.join(hop_line)}; host k-hop "
            f"{khop_ms:.1f} ms ({layers} hops), subgraph schedule build "
            f"{sched_ms:.1f} ms, device forward {fwd_ms:.1f} ms")
        logits = {}
        for name, store in stores.items():
            store.reset_stats()
            t0 = time.perf_counter()
            store.fetch(nodes)
            torch.cuda.synchronize()
            fetch_ms = (time.perf_counter() - t0) * 1e3
            st = store.stats
            store.reset_stats()
            _build.launches.clear()
            t0 = time.perf_counter()
            out = predict_nodes(model, None, g, store, seeds, hops=layers)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
            counts = dict(_build.launches)
            if counts != {"maxk_fwd": layers, "csr_spmm": layers}:
                raise AssertionError(f"serve request of {size}, {name}: "
                                     f"launch counts {counts}")
            logits[name] = out
            log(f"serve request of {size}, {name} store: fetch "
                f"{fetch_ms:.2f} ms, hit rate {st['hit_rate']:.4f}, "
                f"host-to-device bytes {st.get('bytes_from_host', 0)}; "
                f"request wall {wall_ms:.1f} ms; launches {counts}")
        want = full[torch.from_numpy(rows).cuda()]
        scale = float(want.abs().max())
        for name, out in logits.items():
            if not torch.equal(out, logits["device"]):
                raise AssertionError(f"serve request of {size}: the {name} "
                                     f"store's logits differ from the "
                                     f"device store's")
        out = logits["device"]
        row_err = (out - want).abs().amax(1)
        off = int((row_err > 1e-4 * scale).sum())
        agree = float((out.argmax(1) == want.argmax(1)).float().mean())
        ok_rows = row_err <= 1e-4 * scale
        in_tol = float(row_err[ok_rows].max()) / scale if ok_rows.any() \
            else 0.0
        if off > 0.005 * len(rows) or agree < 0.995:
            raise AssertionError(f"serve request of {size}: {off} rows off "
                                 f"by more than 1e-4 of max |logit|, argmax "
                                 f"agreement {agree}")
        log(f"serve request of {size}: logits against the full-graph eval "
            f"forward (the stream plan): {len(rows) - off} rows within "
            f"{in_tol:.3e} of max |logit|, {off} rows off (MaxK near-ties), "
            f"argmax agreement {agree:.4f}; every store's logits equal")

def host_core_phase(torch, g) -> None:
    """The host graph core (phase 7a): the native library must be built
    (nvcc needs a host g++, so the compiler is there). The products
    stand-in's edges in a seeded random order, as an npz delivers an edge
    list, through `from_edges` (told the graph is symmetric, so that only
    the CSR sort differs) with the native sort and with numpy's: every
    array bitwise equal, and equal to the stand-in's own; both times
    printed. (The stand-in's own build sorts nothing in `from_edges`: its
    `to_undirected` hands over the edges in CSR order.)"""
    import numpy as np
    from spgemm_gnn_tpu_torch.graphs import native
    from spgemm_gnn_tpu_torch.graphs.csr import from_edges
    if not native.available():
        raise AssertionError("host graph core: the native library did not "
                             "build (see the INFO log line)")
    log(f"host graph core: {native.library_path()}")
    perm = np.random.default_rng(SEED).permutation(g.num_edges)
    src = g.indices.numpy()[perm].astype(np.int64)
    dst = g.edge_dst.numpy()[perm].astype(np.int64)
    del perm
    fields = ("indptr", "indices", "edge_dst", "t_indptr", "t_indices",
              "t_edge_dst", "in_degrees", "out_degrees")
    times = {}
    for use_native in (True, False):
        t0 = time.perf_counter()
        built = from_edges(src, dst, g.num_nodes, symmetric=True,
                           use_native=use_native)
        times[use_native] = time.perf_counter() - t0
        for f in fields:
            if not torch.equal(getattr(built, f), getattr(g, f)):
                raise AssertionError(f"host graph core: {f} of the "
                                     f"{'native' if use_native else 'numpy'}"
                                     f" build differs")
        del built
    log(f"host graph core: products stand-in edges in random order (E="
        f"{g.num_edges}) to CSR: native {times[True]:.2f} s, numpy "
        f"{times[False]:.2f} s; every array bitwise equal")


def device_inputs_phase(torch, cfg, with_payload_s: float) -> tuple:
    """`--device_inputs` on the Reddit recipe (phase 12c): the stand-in
    built without its payload (host time printed beside the build with
    it, phase 3), features and labels drawn on the card, 3 epochs, finite
    losses and the f32 path's exact launch counts. Returns the Reddit
    dataset (for the plan-cache phase)."""
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    t0 = time.perf_counter()
    ds = load_dataset("reddit", allow_synthetic=True, data_path="/nonexistent",
                      synthetic_scale=SCALE, seed=SEED,
                      synthetic_payload=False)
    t_build = time.perf_counter() - t0
    log(f"device inputs: reddit stand-in host build {t_build:.1f} s without "
        f"the payload, {with_payload_s:.1f} s with it (phase 3)")
    epochs, layers = 3, cfg.hidden_layers
    tr = Trainer(cfg.replace(device_inputs=True, epochs=epochs), dataset=ds)
    if tr.features.device.type != tr.device.type or ds.features.any():
        raise AssertionError("device inputs: the features were not drawn on "
                             "the card")
    run_training(torch, tr, {
        "maxk_fwd": epochs * 2 * layers, "maxk_bwd": epochs * layers,
        "csr_spmm": epochs * 3 * layers}, "train reddit, device inputs",
        epochs=epochs)
    del tr
    torch.cuda.empty_cache()
    return ds


def plan_tensors(torch, plan) -> dict:
    """Every tensor and number a plan holds beyond its CSR, by name."""
    from spgemm_gnn_tpu_torch.graphs.tiles import CSRPlan
    out = {}
    if isinstance(plan, CSRPlan):
        for key, s in plan._schedules.items():
            for f in ("indices", "block_indptr", "seg", "fix", "pass_seg",
                      "pass_fix"):
                out[f"{key}.{f}"] = getattr(s, f)
            out[f"{key}.meta"] = (s.nb, s.block_rows, s.segment, s.n_slots)
        return out
    out.update(chunk_row0=plan.chunk_row0, carry_rows=plan.carry_rows,
               meta=(plan.chunk, plan.warp_chunks))
    for key, v in plan._hot.items():
        if key == "order":
            out["order_ids"], out["order_counts"] = v
        elif key == "positions":
            out["positions"] = v
        else:
            out[f"{key}.meta"] = (v.rows, v.row_bytes, v.budget,
                                  v.edge_share)
            out[f"{key}.mask"] = v.mask
    return out


def plan_cache_phase(torch, g, what: str, dtype, workdir: str) -> None:
    """The plan disk cache on one stand-in (phases 12b, 12c): a build with
    no cache, a cold build into `workdir` (build and store), a warm load;
    every tensor of the loaded plans equal to the built ones' (on the
    card), and the aggregation forward and backward on the loaded plans
    bitwise the built plans'. The three times are printed."""
    from spgemm_gnn_tpu_torch.kernels.planned import (plan_graph,
                                                      planned_aggregate)
    times, plans = {}, {}
    for run, cache in (("build", None), ("cold", workdir), ("warm", workdir)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plans[run] = plan_graph(g, dim=HIDDEN, dtype=dtype, cache_dir=cache)
        torch.cuda.synchronize()
        times[run] = time.perf_counter() - t0
    for side in ("fwd_plan", "bwd_plan"):
        a = plan_tensors(torch, getattr(plans["warm"], side))
        b = plan_tensors(torch, getattr(plans["build"], side))
        if a.keys() != b.keys():
            raise AssertionError(f"plan cache, {what}: {side} holds "
                                 f"{sorted(a)} against {sorted(b)}")
        for k in a:
            same = (torch.equal(a[k], b[k]) and a[k].device == b[k].device
                    if isinstance(a[k], torch.Tensor) else a[k] == b[k])
            if not same:
                raise AssertionError(f"plan cache, {what}: {side} {k} "
                                     f"differs after the load")
    gen = torch.Generator(device=g.device).manual_seed(SEED)
    x = torch.randn((g.num_nodes, HIDDEN), generator=gen,
                    device=g.device).to(dtype)
    ct = torch.randn((g.num_nodes, HIDDEN), generator=gen,
                     device=g.device).to(dtype)
    outs = []
    for run in ("warm", "build"):
        xt = x.clone().requires_grad_(True)
        y = planned_aggregate(plans[run], xt, "mean")
        y.backward(ct)
        outs.append((y.detach(), xt.grad))
    if not all(bits_equal(torch, u, v) for u, v in zip(*outs)):
        raise AssertionError(f"plan cache, {what}: the aggregation on the "
                             f"loaded plan is not bitwise the built plan's")
    size = sum(p.stat().st_size for p in Path(workdir).glob("plan_*.npz"))
    log(f"plan cache, {what} ({plans['build'].kind}): build "
        f"{times['build']:.3f} s, cold (build + store) "
        f"{times['cold']:.3f} s, warm load {times['warm']:.3f} s "
        f"({size / 2**20:.1f} MiB on disk); every plan "
        f"tensor equal, the aggregation forward and backward bitwise; "
        f"{'the load' if times['warm'] < times['build'] else 'the build'} is "
        f"faster")
    for p in Path(workdir).glob("plan_*.npz"):
        p.unlink()


def remat_phase(torch, cfg2, ds2) -> None:
    """`--remat` on the products recipe (phase 12a): SAGE f32, 3 epochs
    without and with it: the losses and the final weights bit-equal, the
    aggregation not rerun (exact launch counts: MaxK's forward once more
    a layer per train step), peak memory and steady epoch of both. Each
    run starts after a garbage collection, so that an earlier phase's
    unreachable tensors are not counted in its peak; the memory held when
    it starts is printed beside the peaks."""
    import gc
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    epochs, layers = 3, cfg2.hidden_layers
    base = {"maxk_fwd": epochs * 2 * layers, "maxk_bwd": epochs * layers,
            "cbsr_compact": epochs * 2 * layers,
            "stream_cbsr_spmm": epochs * 2 * layers,
            "stream_spmm": epochs * layers}
    runs, held = {}, {}
    for remat in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        held[remat] = torch.cuda.memory_allocated() / 2**30
        want = dict(base)
        if remat:
            want["maxk_fwd"] += epochs * layers
        runs[remat] = run_training(
            torch, Trainer(cfg2.replace(epochs=epochs, remat=remat),
                           dataset=ds2), want,
            f"train products, remat {'on' if remat else 'off'}",
            epochs=epochs)
        torch.cuda.empty_cache()
    off, on = runs[False], runs[True]
    if on["losses"] != off["losses"]:
        raise AssertionError(f"remat: losses {on['losses']} against "
                             f"{off['losses']} without it")
    a = on["res"]["final_state"]["model"].state_dict()
    b = off["res"]["final_state"]["model"].state_dict()
    if not all(torch.equal(a[n], b[n]) for n in a):
        raise AssertionError("remat: the final weights differ")
    if not on["peak_gib"] < off["peak_gib"]:
        raise AssertionError(f"remat: peak memory {on['peak_gib']:.2f} GiB "
                             f"did not fall below {off['peak_gib']:.2f}")
    log(f"remat, products f32: losses and final weights bit-equal; peak "
        f"memory {on['peak_gib']:.2f} GiB with remat, {off['peak_gib']:.2f} "
        f"without (held at the start {held[True]:.2f}, {held[False]:.2f}); "
        f"steady epoch {on['res']['steady_epoch_s']} s with, "
        f"{off['res']['steady_epoch_s']} s without")


def remat_graph_check(cfg, ds) -> None:
    """The Reddit bfloat16 recipe with `--remat` and `--steps_per_call 4`:
    a rematerialised step is not captured, and the run raises the
    documented NotImplementedError before its first step."""
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    cfg_r = cfg.replace(dtype="bfloat16", remat=True, steps_per_call=4,
                        eval_every=5)
    try:
        Trainer(cfg_r, dataset=ds).run()
    except NotImplementedError as exc:
        log(f"remat with --steps_per_call 4 (reddit, bfloat16): raises "
            f"NotImplementedError, as documented ({exc})")
        return
    raise AssertionError("remat with --steps_per_call 4 did not raise")


def proteins_phase(torch) -> dict:
    """The ogbn-proteins recipe (phase 12d): the full stand-in (N 132,534, E
    about 79M, 8 features, 112 classes), SAGE MaxK k 32, 3 x 256,
    LayerNorm, dropout 0.5, lr 0.01, 5 epochs, f32 then `--dtype
    bfloat16`: the windowed kind, finite losses, exact launch counts; then
    the f32 run's train / val / test ROC-AUC from the card held within
    1e-6 of the host `rocauc` on the same logits, the on-card evaluation
    timed. Returns each run's counts."""
    from spgemm_gnn_tpu_torch.graphs import native
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.kernels.planned import plan_graph
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    from spgemm_gnn_tpu_torch.train.metrics import rocauc, rocauc_tensor
    t0 = time.perf_counter()
    ds = load_dataset("ogbn-proteins", allow_synthetic=True,
                      data_path="/nonexistent", synthetic_scale=SCALE,
                      seed=SEED)
    log(f"graph 4: ogbn-proteins stand-in scale {SCALE}: N={ds.num_nodes} "
        f"E={ds.graph.num_edges} features={ds.features.shape[1]} "
        f"classes={ds.num_classes}, host build "
        f"{time.perf_counter() - t0:.1f} s, native graph core "
        f"{native.available()}")
    ds.graph = ds.graph.to("cuda")
    if plan_graph(ds.graph).kind != "windowed":
        raise AssertionError("plan rule: ogbn-proteins must take the "
                             "windowed kind")
    layers = 3
    cfg = TrainConfig(dataset="ogbn-proteins", model="sage",
                      nonlinear="maxk", maxk=K, hidden_dim=HIDDEN,
                      hidden_layers=layers, norm=True, dropout=0.5,
                      w_lr=0.01, epochs=EPOCHS, eval_every=1, seed=SEED,
                      device="cuda", impl="auto", synthetic=True,
                      synthetic_scale=SCALE)
    tr = Trainer(cfg, dataset=ds)
    f32 = run_training(torch, tr, {
        "maxk_fwd": EPOCHS * 2 * layers, "maxk_bwd": EPOCHS * layers,
        "csr_spmm": EPOCHS * 3 * layers}, "train proteins")
    state = f32["res"]["final_state"]
    model = state["model"].eval()
    with torch.no_grad():
        logits = model(tr.g, tr.features)
        torch.cuda.synchronize()
        ms = time_ms(torch, lambda: [rocauc_tensor(logits, tr.labels, m)
                                     for m in tr.masks], 3)
        got = [float(rocauc_tensor(logits, tr.labels, m)) for m in tr.masks]
    host = logits.cpu().numpy()
    labels = tr.labels.cpu().numpy()
    want = [rocauc(host, labels, m.cpu().numpy()) for m in tr.masks]
    err = max(abs(a - b) for a, b in zip(got, want))
    if not err <= 1e-6:
        raise AssertionError(f"proteins ROC-AUC: card {got} against host "
                             f"{want}")
    log(f"proteins ROC-AUC train / val / test: card {got}, host {want}, "
        f"max difference {err:.3e}; the three on the card "
        f"{ms:.3f} ms (logits [{logits.shape[0]}, {logits.shape[1]}])")
    del tr, model, state, logits, f32["res"]
    torch.cuda.empty_cache()
    b16 = run_training(torch, Trainer(cfg.replace(dtype="bfloat16"),
                                      dataset=ds), {
        "maxk_fwd_bf16": EPOCHS * 2 * layers,
        "maxk_bwd_bf16": EPOCHS * layers,
        "layer_norm16_fwd": EPOCHS * 2 * layers,
        "layer_norm16_bwd": EPOCHS * layers,
        "cbsr_compact_bf16": EPOCHS * 2 * layers,
        "csr_cbsr_spmm_bf16_out": EPOCHS * 2 * layers,
        "csr_sspmm_bf16_out": EPOCHS * layers}, "train proteins, bfloat16")
    del ds, b16["res"]
    torch.cuda.empty_cache()
    return {"f32": f32["counts"], "bfloat16": b16["counts"]}


# the batched-steps check: steps_per_call groups of 4 between evaluations
# every 5 epochs (an eval every epoch would leave no group to batch)
BATCH_STEPS, BATCH_EVAL = 4, 5
# the harness at `bench.py --scale medium`: an eighth of Reddit's nodes at
# its average degree
MEDIUM = (29_121, 14_325_000)


def bench_phase(torch, cfg, ds) -> None:
    """Timing and the benches on the Reddit recipe's graph (phase 5b): the
    aggregation share of a step (utils/timing.py) at f32 and bfloat16; the
    bfloat16 recipe for 5 epochs with steps_per_call 4 (a CUDA graph of the
    step), its losses and final weights bit-equal to steps_per_call 1 and
    its executed launches equal (captured × replays + eager); the harness
    at medium scale (bench_aggregation with torch, ell and cuda; ELL within
    1e-5 of max |y| of a float64 plain sum; validate_numerics passing);
    then `python -m spgemm_gnn_tpu_torch.bench --scale medium` in a
    subprocess, its one JSON line parsed. Each number beside the card's
    name and power limit."""
    from spgemm_gnn_tpu_torch.bench import harness
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.kernels.api import aggregate
    from spgemm_gnn_tpu_torch.ops.ell import ell_graph
    from spgemm_gnn_tpu_torch.ops.spmm import spmm
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    from spgemm_gnn_tpu_torch.utils.timing import measure_aggregation_fraction

    t_phase = time.perf_counter()
    dev = ds.graph.device
    card = harness.card(dev)
    for dtype in ("float32", "bfloat16"):
        tr = Trainer(cfg.replace(dtype=dtype), dataset=ds)
        stats = measure_aggregation_fraction(tr)
        if not (stats["step_s"] > 0 and stats["aggregation_s"] > 0
                and 0 < stats["aggregation_pct"] <= 100):
            raise AssertionError(f"timing reddit {dtype}: {stats}")
        log(f"timing reddit {dtype}: step_s {stats['step_s']}, "
            f"aggregation_s {stats['aggregation_s']}, aggregation_pct "
            f"{stats['aggregation_pct']} ({card})")
        del tr
        torch.cuda.empty_cache()

    cfg_b = cfg.replace(dtype="bfloat16", eval_every=BATCH_EVAL)
    runs = {}
    for spc in (1, BATCH_STEPS):
        _build.launches.clear()
        res = Trainer(cfg_b.replace(steps_per_call=spc), dataset=ds).run()
        torch.cuda.synchronize()
        runs[spc] = dict(res=res, counts=collections.Counter(_build.launches),
                         losses=[r.loss for r in res["history"]])
        log(f"batched steps {spc}: losses {runs[spc]['losses']}, steady "
            f"epoch {res['steady_epoch_s']} s, graph replays "
            f"{res['graph_replays']}, captured launches "
            f"{res['graph_launches']} ({card})")
    one, four = runs[1], runs[BATCH_STEPS]
    if not all(map(math.isfinite, one["losses"])):
        raise AssertionError(f"batched steps: losses {one['losses']}")
    if four["losses"] != one["losses"]:
        raise AssertionError(f"batched steps: losses {four['losses']} at "
                             f"steps_per_call {BATCH_STEPS} vs "
                             f"{one['losses']} at 1")
    p1 = one["res"]["final_state"]["model"].state_dict()
    p4 = four["res"]["final_state"]["model"].state_dict()
    if any(not torch.equal(p1[n], p4[n]) for n in p1):
        raise AssertionError("batched steps: final weights differ from "
                             "steps_per_call 1")
    captured = collections.Counter(four["res"]["graph_launches"])
    replays = four["res"]["graph_replays"]
    if not captured or replays != EPOCHS - 1:
        raise AssertionError(f"batched steps: {replays} replays of "
                             f"{dict(captured)}")
    # the wrappers count a captured launch once, at capture
    executed = four["counts"] - captured + collections.Counter(
        {name: n * replays for name, n in captured.items()})
    if executed != one["counts"]:
        raise AssertionError(f"batched steps: launches {dict(executed)} "
                             f"(captured x replays + eager) != "
                             f"{dict(one['counts'])} at steps_per_call 1")
    log(f"batched steps: losses and final weights bit-equal to "
        f"steps_per_call 1; launches captured once x {replays} replays + "
        f"eager = {dict(executed)}, the unbatched run's; steady epoch "
        f"{four['res']['steady_epoch_s']} s at {BATCH_STEPS}, "
        f"{one['res']['steady_epoch_s']} s at 1 ({card})")
    del runs, one, four, p1, p4
    torch.cuda.empty_cache()

    n, e = MEDIUM
    g, pg, xk, ct = harness._bench_inputs(n, e, HIDDEN, K, 0, None, dev)
    val = harness.validate_numerics(g, pg, xk, ct, HIDDEN, K)
    log(f"harness validate_numerics (medium, N={g.num_nodes} "
        f"E={g.num_edges}): {val}")
    if not val["pass"]:
        raise AssertionError(f"validate_numerics failed: {val}")
    with torch.no_grad():
        y_ell = aggregate(ell_graph(g), xk, "mean", K, "ell")
        y64 = spmm(g, xk.double(), "mean")
    err = float((y_ell.double() - y64).abs().max())
    top = float(y64.abs().max())
    if not err <= 1e-5 * top:
        raise AssertionError(f"ELL: max abs err {err:.3e} against float64 "
                             f"(max |y| {top:.3e})")
    log(f"harness ELL (medium): max abs err {err:.3e} of max |y| {top:.3e} "
        f"against float64, within 1e-5 of it")
    del g, pg, xk, ct, y_ell, y64
    torch.cuda.empty_cache()
    r = harness.bench_aggregation(n, e, HIDDEN, K,
                                  impls=("torch", "ell", "cuda"),
                                  device=dev)
    log(f"harness bench_aggregation (medium, f32 stream): {json.dumps(r)} "
        f"({card})")
    for impl in ("torch", "ell", "cuda"):
        if not (r[impl]["fwd_gedges"] > 0 and r[impl]["bwd_gedges"] > 0):
            raise AssertionError(f"bench_aggregation {impl}: {r[impl]}")
    torch.cuda.empty_cache()

    root = Path(__file__).resolve().parent
    out = subprocess.run(
        [sys.executable, "-m", "spgemm_gnn_tpu_torch.bench", "--scale",
         "medium"], cwd=root, check=True, capture_output=True, text=True,
        timeout=300)
    lines = out.stdout.strip().splitlines()
    if len(lines) != 1:
        raise AssertionError(f"bench --scale medium printed {len(lines)} "
                             f"lines: {out.stdout!r}")
    line = json.loads(lines[0])
    for key in ("metric", "value", "unit", "vs_baseline", "vs_ell",
                "stream", "copy_gbps", "gather_gbps", "device"):
        if key not in line:
            raise AssertionError(f"bench line lacks {key!r}: {line}")
    if not (line["value"] > 0 and line["copy_gbps"] > 0
            and line["gather_gbps"] > 0):
        raise AssertionError(f"bench line: {line}")
    log(f"bench --scale medium: {lines[0]}")
    log(f"timing and benches: {time.perf_counter() - t_phase:.1f} s")


# the dropout-0 comparison with one device runs 3 epochs; the recipe
# runs EPOCHS, since its loss at lr 0.01 rises after the first epoch and
# falls below it only from the fourth
MESH_SHARDS, MESH_EPOCHS = 4, 3


def mesh_statics(spg) -> dict:
    """What `mesh_counts` reads of a sharded graph: the shard count, each
    role's kind, and whether it has a halo."""
    return dict(shards=spg.num_shards, kinds=dict(spg.kinds),
                halo=spg.fwd_halo is not None)


def mesh_counts(statics: dict, steps: int, layers: int, bf16: bool,
                evals: int | None = None) -> dict:
    """The exact launches of `steps` train steps and `evals` eval forwards
    (default one a step) of a MaxK model of `layers` aggregations over a
    sharded graph (`mesh_statics`): per aggregation forward each shard's
    local and halo kernel and the halo's compaction, per backward each
    shard's backward pair and the compaction's densify."""
    d, kinds = statics["shards"], statics["kinds"]
    fwds = steps + (steps if evals is None else evals)
    sfx = "_bf16_out" if bf16 else ""
    b = "_bf16" if bf16 else ""
    kernel = {"windowed": "csr_spmm" + sfx, "stream": "stream_spmm" + sfx}
    counts = collections.Counter({f"maxk_fwd{b}": fwds * layers,
                                  f"maxk_bwd{b}": steps * layers})
    for role, calls in (("fwd_local", fwds), ("fwd_halo", fwds),
                        ("bwd_local", steps), ("bwd_halo", steps)):
        if role in kinds:
            counts[kernel[kinds[role]]] += calls * layers * d
    if statics["halo"]:
        counts[f"cbsr_compact{b}"] += fwds * layers
        counts[f"cbsr_densify{b}"] += steps * layers
    if bf16:
        counts.update(layer_norm16_fwd=fwds * layers,
                      layer_norm16_bwd=steps * layers)
    return dict(counts)


def mesh_role_check(torch, spg, dim: int, k: int, seed: int,
                    card: str) -> dict:
    """Each role's per-shard product (its rectangular plan) through its
    kernel on k-sparse rows, f32 and bf16x2 messages, against the plain
    version in float64 on the same rows: within 1e-5 of max |y|, bitwise
    across two runs, timed. Returns {role: {kind, shards: [per shard and
    stream]}}."""
    from spgemm_gnn_tpu_torch.kernels.round import round_rows
    from spgemm_gnn_tpu_torch.kernels.spmm import csr_spmm
    from spgemm_gnn_tpu_torch.kernels.stream import stream_spmm
    from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain
    gen = torch.Generator(device=spg.mesh.device).manual_seed(seed)
    roles = ["fwd_local", "fwd_halo", "bwd_halo"]
    if spg.bwd_local is not spg.fwd_local:
        roles.insert(1, "bwd_local")
    out = {}
    for role in roles:
        plans = getattr(spg, role)
        if plans is None:
            continue
        kernel = csr_spmm if plans[0].kind == "windowed" else stream_spmm
        rows = []
        for c, plan in enumerate(plans):
            x = sparse_input(torch, plan.num_src, dim, k, gen)
            for stream, m in (("f32", x), ("bf16x2", round_rows(x))):
                got, again = kernel(plan, m), kernel(plan, m)
                ref = csr_spmm_plain(plan.indptr, plan.indices, m.double())
                rel = rel_err(got, ref)[1]
                if not rel <= 1e-5:
                    raise AssertionError(f"mesh {role} shard {c} {stream}: "
                                         f"error {rel:.3e} of max |y|")
                if not bits_equal(torch, got, again):
                    raise AssertionError(f"mesh {role} shard {c} {stream}: "
                                         f"two runs differ")
                rows.append(dict(
                    shard=c, stream=stream, rows=plan.num_rows,
                    sources=plan.num_src, edges=plan.indices.numel(),
                    rel=rel, ms=time_ms(torch, lambda: kernel(plan, m), 5)))
            del x, got, again, ref
        out[role] = dict(kind=plans[0].kind, shards=rows)
        log(f"mesh {role} ({plans[0].kind}, {kernel.__name__}): " + "; ".join(
            f"shard {r['shard']} {r['stream']}: {r['rows']} rows x "
            f"{r['sources']} sources, {r['edges']} edges, {r['ms']:.3f} ms, "
            f"{r['rel']:.2e} of max |y|" for r in rows) + f" [{card}]")
    return out


def mesh_aggregate_check(torch, g, spg, dim: int, k: int, seed: int,
                         card: str) -> dict:
    """`sharded_planned_aggregate` (mean) on the k-sparse rows of the
    path, forward and input gradient, against the plain product in
    float64: the dense and the CBSR exchange within 1e-5 of max |y| (the
    gradient of the CBSR exchange on the MaxK support), the bf16 halo and
    the bf16x2 stream within 3e-2; the single-device `planned_aggregate`
    beside them. Times each forward."""
    from spgemm_gnn_tpu_torch.kernels import planned
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.ops.spmm import csr_spmm_plain
    from spgemm_gnn_tpu_torch.parallel.planned_sharded import (
        sharded_planned_aggregate)
    n, n_pad, dev = g.num_nodes, spg.padded_nodes, spg.mesh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = sparse_input(torch, n, dim, k, gen)
    ct = torch.randn((n, dim), generator=gen, device=dev)
    _, post = node_factors(g, "mean")
    y64 = csr_spmm_plain(g.indptr, g.indices, x.double(), None,
                         post.double())
    dx64 = csr_spmm_plain(g.t_indptr, g.t_indices,
                          (ct * post[:, None]).double())
    sup = x != 0

    def padded(t):
        out = torch.zeros((n_pad, dim), device=dev)
        out[:n] = t
        return out

    ctp = padded(ct)
    results = {}
    pg = planned.plan_graph(g, dim=dim)
    for name, kk, halo, stream, tol in (
            ("dense", None, None, "f32", 1e-5),
            ("cbsr", k, None, "f32", 1e-5),
            ("cbsr_halo_bf16", k, torch.bfloat16, "f32", 3e-2),
            ("bf16x2", k, None, "bf16x2", 3e-2),
            ("single_device", k, None, "f32", 1e-5)):
        planned.DEFAULT_STREAM = stream
        try:
            if name == "single_device":
                xin = x.clone().requires_grad_()

                def fwd(v=xin):
                    return planned.planned_aggregate(pg, v, "mean", k)
                y = fwd()
                (y * ct).sum().backward()
            else:
                xin = padded(x).requires_grad_()

                def fwd(v=xin, kk=kk, halo=halo):
                    return sharded_planned_aggregate(spg, v, "mean", kk,
                                                     halo)
                y = fwd()
                (y * ctp).sum().backward()
            with torch.no_grad():
                ms = time_ms(torch, fwd, 5)
        finally:
            planned.DEFAULT_STREAM = "f32"
        y, dx = y.detach()[:n], xin.grad[:n]
        if name != "dense" and name != "single_device":
            dx = torch.where(sup, dx, torch.zeros_like(dx))
            want_dx = torch.where(sup, dx64, torch.zeros_like(dx64))
        else:
            want_dx = dx64
        fwd_rel, bwd_rel = rel_err(y, y64)[1], rel_err(dx, want_dx)[1]
        if not (fwd_rel <= tol and bwd_rel <= tol):
            raise AssertionError(f"mesh aggregate {name}: forward "
                                 f"{fwd_rel:.3e}, gradient {bwd_rel:.3e} "
                                 f"of max |y| > {tol}")
        results[name] = dict(fwd_rel=fwd_rel, bwd_rel=bwd_rel, ms=ms)
        log(f"mesh aggregate {name}: forward {fwd_rel:.3e}, input gradient "
            f"{bwd_rel:.3e} of max |y| of float64 (limit {tol}); forward "
            f"{ms:.3f} ms [{card}]")
        del y, dx, xin
    return results


def mesh_phase(torch, ds, cfg, single: dict, card: str) -> dict:
    """Phase 5a (module docstring): the Reddit recipe over a mesh of
    MESH_SHARDS shards on the card. `single` is phase 5's f32 recipe run.
    Returns the counts of the mesh recipe runs and the sweep, and B2's
    per-role times."""
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.parallel import dryrun, make_mesh
    from spgemm_gnn_tpu_torch.parallel.planned_sharded import (
        shard_planned_graph)
    from spgemm_gnn_tpu_torch.train.loop import Trainer

    t_phase = time.perf_counter()
    g = ds.graph
    layers = cfg.hidden_layers
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        spg = shard_planned_graph(g, make_mesh(MESH_SHARDS),
                                  cache_dir=f"{workdir}/plans", dim=HIDDEN)
        torch.cuda.synchronize()
        log(f"mesh build: {time.perf_counter() - t0:.1f} s (host build, "
            f"stored, and each shard's plans on the card) for "
            f"{MESH_SHARDS} shards of {spg.nodes_per_shard} rows "
            f"({spg.padded_nodes} with padding); kinds {spg.kinds}; round "
            f"sizes {spg.halo_round_sizes}, boundary rows "
            f"{spg.boundary_rows} [{card}]")
        for what, kk, vb in (("dense f32", None, 4), ("CBSR f32", K, 4),
                             ("CBSR, bf16 halo", K, 2)):
            st = spg.comm_stats(HIDDEN, kk, vb)
            log(f"mesh comm_stats ({what}, dim {HIDDEN}): exchange "
                f"{st['exchange_bytes']} B a layer ({st['halo_rows_padded']}"
                f" padded rows, padding {st['padding_ratio']:.3f}) against "
                f"the full gather's {st['full_gather_bytes']} B: "
                f"{st['ratio_vs_full_gather']:.4f}")
        roles = mesh_role_check(torch, spg, HIDDEN, K, SEED, card)
        aggregates = mesh_aggregate_check(torch, g, spg, HIDDEN, K, SEED,
                                          card)
        # each Trainer builds its own shard plans (from the stored build):
        # this copy goes before they run, so that their peaks count theirs
        statics = mesh_statics(spg)
        del spg
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        _build.launches.clear()
        sweep = dryrun.run_sweep(MESH_SHARDS)
        sweep_counts = dict(_build.launches)
        for r in sweep:
            log(f"mesh sweep {r['config']}: kinds {r['plan_kinds']}, forward "
                f"{r['fwd_relerr']:.3e}, gradient {r['bwd_relerr']:.3e}, "
                f"exchange {r['exchange_bytes']} B of "
                f"{r['full_gather_bytes']}")
        log(f"mesh sweep: all {len(sweep)} configs within tolerance, "
            f"{time.perf_counter() - t0:.1f} s, launches {sweep_counts}")

        # the Trainer reads the stored build (an npz dataset's rule)
        cfg_m = cfg.replace(mesh_shape=MESH_SHARDS, synthetic=False,
                            data_path=workdir, epochs=MESH_EPOCHS)
        t0 = time.perf_counter()
        plain = Trainer(cfg.replace(dropout=0.0, epochs=MESH_EPOCHS),
                        dataset=ds).run()
        mesh = Trainer(cfg_m.replace(dropout=0.0), dataset=ds).run()
        l1 = [r.loss for r in plain["history"]]
        l4 = [r.loss for r in mesh["history"]]
        rel = [abs(a - b) / abs(b) for a, b in zip(l4, l1)]
        if not rel[0] <= 1e-4:
            raise AssertionError(f"mesh Trainer: first loss {l4[0]} vs "
                                 f"{l1[0]} on one device ({rel[0]:.3e})")
        log(f"mesh Trainer, dropout 0: losses {l4}, one device {l1}, "
            f"relative differences {rel} ({time.perf_counter() - t0:.1f} s)")
        del plain, mesh
        torch.cuda.empty_cache()

        cfg_m = cfg_m.replace(epochs=EPOCHS)
        before = torch.cuda.memory_allocated() / 2**30
        f32 = run_training(torch, Trainer(cfg_m, dataset=ds),
                           mesh_counts(statics, EPOCHS, layers, False),
                           "train reddit, mesh 4")
        require_fall(f32, "train reddit, mesh 4")
        log(f"train reddit, mesh 4: steady epoch "
            f"{f32['res']['steady_epoch_s']} s, peak memory "
            f"{f32['peak_gib']:.2f} GiB ({before:.2f} resident before the "
            f"Trainer was made, {f32['resident_gib']:.2f} at the run's "
            f"start); one device (phase 5) "
            f"{single['res']['steady_epoch_s']} s, {single['peak_gib']:.2f} "
            f"GiB ({single['resident_gib']:.2f} at the run's start); "
            f"launches an epoch "
            f"{ {k: v // EPOCHS for k, v in f32['counts'].items()} } "
            f"[{card}]")
        b16 = run_training(torch, Trainer(cfg_m.replace(dtype="bfloat16"),
                                          dataset=ds),
                           mesh_counts(statics, EPOCHS, layers, True),
                           "train reddit, mesh 4, bfloat16")
        require_fall(b16, "train reddit, mesh 4, bfloat16")
        counts = {"f32": f32["counts"], "bfloat16": b16["counts"]}
        del f32, b16
        torch.cuda.empty_cache()
        mesh_steps_check(torch, ds, cfg_m, statics, card)

    t0 = time.perf_counter()
    rec = dryrun.run_trajectory_match(MESH_SHARDS)
    log(f"mesh trajectory match: {rec} ({time.perf_counter() - t0:.1f} s)")
    log(f"phase mesh: {time.perf_counter() - t_phase:.1f} s [{card}]")
    return dict(counts=counts, sweep_counts=sweep_counts, roles=roles,
                aggregates=aggregates)


def mesh_steps_check(torch, ds, cfg_m, statics: dict, card: str) -> None:
    """The Reddit recipe over the mesh (f32, dropout 0.5) for EPOCHS epochs
    with evaluations every BATCH_EVAL, at `--steps_per_call` 1 and
    BATCH_STEPS: the batched run captures the sharded step as a CUDA graph
    and replays it EPOCHS - 1 times; its losses and final weights are
    bit-equal to the unbatched run's, and both runs' executed launches
    (captured once x replays + eager) are `mesh_counts`' exactly."""
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    cfg_b = cfg_m.replace(eval_every=BATCH_EVAL)
    evals = sum(e % BATCH_EVAL == 0 or e == EPOCHS - 1
                for e in range(EPOCHS))
    want = collections.Counter(mesh_counts(statics, EPOCHS,
                                           cfg_m.hidden_layers, False, evals))
    runs = {}
    for spc in (1, BATCH_STEPS):
        _build.launches.clear()
        res = Trainer(cfg_b.replace(steps_per_call=spc), dataset=ds).run()
        torch.cuda.synchronize()
        counts = collections.Counter(_build.launches)
        captured = collections.Counter(res["graph_launches"])
        replays = res["graph_replays"]
        # the wrappers count a captured launch once, at capture
        executed = counts - captured + collections.Counter(
            {name: n * replays for name, n in captured.items()})
        runs[spc] = dict(res=res, losses=[r.loss for r in res["history"]])
        log(f"mesh batched steps {spc}: losses {runs[spc]['losses']}, "
            f"steady epoch {res['steady_epoch_s']} s, graph replays "
            f"{replays}, captured launches {dict(captured)} [{card}]")
        if executed != want:
            raise AssertionError(f"mesh batched steps {spc}: launches "
                                 f"{dict(executed)} (captured x replays + "
                                 f"eager) != {dict(want)}")
        if spc > 1 and (not captured or replays != EPOCHS - 1):
            raise AssertionError(f"mesh batched steps: {replays} replays "
                                 f"of {dict(captured)}")
    one, four = runs[1], runs[BATCH_STEPS]
    if not all(map(math.isfinite, one["losses"])):
        raise AssertionError(f"mesh batched steps: losses {one['losses']}")
    if four["losses"] != one["losses"]:
        raise AssertionError(f"mesh batched steps: losses {four['losses']} "
                             f"at steps_per_call {BATCH_STEPS} vs "
                             f"{one['losses']} at 1")
    p1 = one["res"]["final_state"]["model"].state_dict()
    p4 = four["res"]["final_state"]["model"].state_dict()
    if any(not torch.equal(p1[n], p4[n]) for n in p1):
        raise AssertionError("mesh batched steps: final weights differ from "
                             "steps_per_call 1")
    log(f"mesh batched steps: a CUDA graph of the sharded step, replayed "
        f"{four['res']['graph_replays']} times; losses and final weights "
        f"bit-equal to steps_per_call 1, and both runs' launches "
        f"(captured x replays + eager) {dict(want)} exactly; steady epoch "
        f"{four['res']['steady_epoch_s']} s at {BATCH_STEPS}, "
        f"{one['res']['steady_epoch_s']} s at 1 [{card}]")
    del runs, one, four, p1, p4
    torch.cuda.empty_cache()


# the ranks phase (5c): the Reddit recipe over RANKS processes, one graph
# shard a rank, all on the one GPU over gloo; each rank trains RANK_EPOCHS
# epochs in f32 and in bfloat16 through the CLI's main, within RANK_TIMEOUT
RANKS, RANK_EPOCHS, RANK_TIMEOUT = 2, 3, 480


def rank_argv(coordinator: str, rank: int, workdir: str, dtype: str
              ) -> list[str]:
    """The CLI's flags of the Reddit recipe on rank `rank` of RANKS, the
    stand-in read from workdir's npz."""
    return ["--dataset", "reddit", "--data_path", workdir, "--model", "sage",
            "--nonlinear", "maxk", "--maxk", str(K), "--hidden_dim",
            str(HIDDEN), "--hidden_layers", "4", "--norm", "--dropout", "0.5",
            "--w_lr", "0.01", "--epochs", str(RANK_EPOCHS), "--seed",
            str(SEED), "--dtype", dtype, "--device", "cuda", "--mesh_shape",
            str(RANKS), "--multihost", "--coordinator", coordinator,
            "--num_processes", str(RANKS), "--process_id", str(rank),
            "--path", f"{workdir}/run_{dtype}"]


def rank_aggregate_check(torch, rank: int, workdir: str,
                         symmetric: bool) -> dict:
    """On one rank: `sharded_planned_aggregate` (sum) of this rank's
    block, through the halo rounds over gloo, against the in-process mesh
    of RANKS shards on the same card and the same inputs (a seeded
    integer-valued k-sparse x and integer cotangent, so every sum is
    exact): the forward and dx bit for bit, dense, CBSR and CBSR with a
    bf16 halo; each form's forward timed, and its exchange's host
    milliseconds and bytes a call. Builds (shard 0) or loads the sharded
    host build in workdir/plans, which the CLI runs then load. The graph
    comes from the npz's edges with its symmetry given (the CLI's load
    detects it, two sorts of E keys)."""
    import numpy as np
    from spgemm_gnn_tpu_torch.graphs.csr import from_edges
    from spgemm_gnn_tpu_torch.parallel.mesh import Mesh, make_mesh
    from spgemm_gnn_tpu_torch.parallel.planned_sharded import (
        shard_planned_graph, sharded_planned_aggregate)
    t0 = time.perf_counter()
    with np.load(f"{workdir}/reddit.npz") as z:
        g = from_edges(z["edge_src"], z["edge_dst"], len(z["train_mask"]),
                       symmetric=symmetric)
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    mesh = make_mesh(RANKS, "cuda")
    spg = shard_planned_graph(g, mesh, cache_dir=f"{workdir}/plans",
                              dim=HIDDEN)
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    whole = shard_planned_graph(g, Mesh(RANKS, mesh.device),
                                cache_dir=f"{workdir}/plans", dim=HIDDEN)
    dev, n_pad, nps = mesh.device, spg.padded_nodes, spg.nodes_per_shard
    rows = slice(rank * nps, (rank + 1) * nps)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    cols = torch.rand((n_pad, HIDDEN), generator=gen,
                      device=dev).argsort(dim=1)[:, :K]
    x = torch.zeros((n_pad, HIDDEN), device=dev).scatter_(
        1, cols, torch.randint(1, 9, (n_pad, K), generator=gen,
                               device=dev).float())
    x[g.num_nodes:] = 0
    ct = torch.randint(-4, 5, (n_pad, HIDDEN), generator=gen,
                       device=dev).float()
    del cols
    out = dict(load_s=t_load, build_s=t_build, kinds=dict(spg.kinds),
               halo=spg.fwd_halo is not None,
               rounds=list(spg.halo_round_sizes), nps=nps, forms={})
    for name, k, halo in (("dense", None, None), ("cbsr", K, None),
                          ("cbsr_bf16_halo", K, torch.bfloat16)):
        xr = x[rows].clone().requires_grad_()
        y = sharded_planned_aggregate(spg, xr, "sum", k, halo)
        (y * ct[rows]).sum().backward()
        xw = x.clone().requires_grad_()
        yw = sharded_planned_aggregate(whole, xw, "sum", k, halo)
        (yw * ct).sum().backward()
        before = collections.Counter(mesh.stats)
        with torch.no_grad():
            ms = time_ms(torch, lambda: sharded_planned_aggregate(
                spg, x[rows], "sum", k, halo), 3)
        st = collections.Counter(mesh.stats) - before
        calls = st["exchange_calls"]
        value_bytes = 2 if halo is not None else 4
        out["forms"][name] = dict(
            fwd_bitwise=bits_equal(torch, y, yw[rows]),
            dx_bitwise=bits_equal(torch, xr.grad, xw.grad[rows]),
            fwd_ms=ms, exchange_ms=st["exchange_ms"] / calls,
            exchange_bytes=st["exchange_bytes"] // calls,
            staged_bytes=st["exchange_staged_bytes"] // calls,
            comm_stats_bytes=spg.comm_stats(HIDDEN, k, value_bytes)[
                "exchange_bytes"] // RANKS)
        del xr, y, xw, yw
    del whole, spg, x, ct
    torch.cuda.empty_cache()
    return out


def rank_main(argv: list[str]) -> int:
    """One rank of the ranks phase (`chip_smoke.py --rank R --coordinator
    HOST:PORT --workdir DIR`, started by `ranks_phase`): the process group,
    `rank_aggregate_check`, then the Reddit recipe through the CLI's main
    in f32 and in bfloat16, its launches counted from zero before each
    run; the results into DIR/rank<R>.json."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--rank", type=int, required=True)
    p.add_argument("--coordinator", required=True)
    p.add_argument("--workdir", required=True)
    p.add_argument("--symmetric", type=int, required=True)
    a = p.parse_args(argv)
    import torch
    from spgemm_gnn_tpu_torch.kernels import _build
    from spgemm_gnn_tpu_torch.parallel.multihost import (
        initialize_multihost, process_summary)
    from spgemm_gnn_tpu_torch.train.__main__ import main as cli
    initialize_multihost(a.coordinator, RANKS, a.rank, "cuda")
    out = {"summary": process_summary("cuda")}
    log(f"rank {a.rank}: process_summary {out['summary']}")
    out["aggregate"] = rank_aggregate_check(torch, a.rank, a.workdir,
                                            bool(a.symmetric))
    for dtype in ("float32", "bfloat16"):
        torch.cuda.reset_peak_memory_stats()
        _build.launches.clear()
        t0 = time.perf_counter()
        res = cli(rank_argv(a.coordinator, a.rank, a.workdir, dtype))
        torch.cuda.synchronize()
        out[dtype] = dict(
            losses=[r.loss for r in res["history"]],
            steady_epoch_s=res["steady_epoch_s"], cli_s=time.perf_counter()
            - t0, peak_gib=torch.cuda.max_memory_allocated() / 2**30,
            launches=dict(_build.launches), collectives=res["collectives"])
        del res
        torch.cuda.empty_cache()
    with open(f"{a.workdir}/rank{a.rank}.json", "w") as f:
        json.dump(out, f)
    return 0


def write_reddit_npz(ds, path: str) -> None:
    """The stand-in in graphs/datasets.py's npz schema."""
    import numpy as np
    host = ds.graph.host_arrays()
    indptr = np.asarray(host["indptr"])
    np.savez(path, edge_src=np.asarray(host["indices"], np.int64),
             edge_dst=np.repeat(np.arange(len(indptr) - 1, dtype=np.int64),
                                np.diff(indptr)),
             feat=ds.features, label=ds.labels, train_mask=ds.train_mask,
             val_mask=ds.val_mask, test_mask=ds.test_mask,
             num_classes=ds.num_classes)


def start_ranks(workdir: str, symmetric: bool) -> list[tuple]:
    """RANKS processes of `rank_main` at a free localhost port, each one's
    output into workdir/rank<R>.log. Waits for all (RANK_TIMEOUT, then
    kills them); returns (rank, exit code, output) a rank."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(RANKS):
        with open(f"{workdir}/rank{r}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, str(Path(__file__).resolve()), "--rank",
                 str(r), "--coordinator", f"127.0.0.1:{port}", "--workdir",
                 workdir, "--symmetric", str(int(symmetric))], stdout=f,
                stderr=subprocess.STDOUT))
    deadline = time.monotonic() + RANK_TIMEOUT
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 1.0))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [(r, p.returncode, Path(f"{workdir}/rank{r}.log").read_text())
            for r, p in enumerate(procs)]


def ranks_phase(torch, ds, cfg, single: dict, card: str) -> dict:
    """Phase 5c (module docstring): the Reddit recipe over RANKS
    processes on the one GPU. `single` is phase 5's f32 recipe run.
    Returns each rank's launches of the f32 and bfloat16 runs."""
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    t_phase = time.perf_counter()
    layers = cfg.hidden_layers
    with tempfile.TemporaryDirectory() as workdir:
        t0 = time.perf_counter()
        write_reddit_npz(ds, f"{workdir}/reddit.npz")
        log(f"ranks: the Reddit stand-in written as {workdir}/reddit.npz "
            f"in {time.perf_counter() - t0:.1f} s")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ran = start_ranks(workdir, ds.graph.symmetric)
        t_ranks = time.perf_counter() - t0
        for r, rc, text in ran:
            for line in text.splitlines():
                log(f"rank {r} | {line}")
        bad = [(r, rc) for r, rc, _ in ran if rc != 0]
        if bad:
            raise AssertionError(f"ranks: rank (exit code) {bad}")
        outs = [json.loads(Path(f"{workdir}/rank{r}.json").read_text())
                for r in range(RANKS)]
        # (a) the runtime: gloo on the one GPU
        for r, out in enumerate(outs):
            s = out["summary"]
            if (s["backend"], s["process_index"], s["process_count"]) != (
                    "gloo", r, RANKS) or not s["device"].startswith("cuda"):
                raise AssertionError(f"ranks: rank {r}'s summary {s}")
            log(f"ranks: rank {r} backend {s['backend']}, device "
                f"{s['device']}, process_summary {s}")
        log("ranks: NCCL not exercised (one GPU on this machine: the ranks "
            "share it over gloo, staged through pinned host memory)")
        # (b) each rank's block bit for bit the in-process mesh's
        for r, out in enumerate(outs):
            agg = out["aggregate"]
            for name, f in agg["forms"].items():
                if not (f["fwd_bitwise"] and f["dx_bitwise"]):
                    raise AssertionError(f"ranks: rank {r} {name}: forward "
                                         f"bitwise {f['fwd_bitwise']}, dx "
                                         f"bitwise {f['dx_bitwise']}")
                log(f"ranks: rank {r} aggregate {name} (sum, integer "
                    f"k-sparse x): forward and dx bit for bit the "
                    f"in-process mesh of {RANKS}; forward {f['fwd_ms']:.3f} "
                    f"ms, exchange {f['exchange_ms']:.3f} ms and "
                    f"{f['exchange_bytes']} B a call ({f['staged_bytes']} B "
                    f"staged), comm_stats {f['comm_stats_bytes']} B a rank "
                    f"[{card}]")
            log(f"ranks: rank {r} graph from the npz {agg['load_s']:.1f} s, "
                f"sharded build {agg['build_s']:.1f} s (shard 0 builds and "
                f"stores, shard 1 loads), kinds {agg['kinds']}, rounds "
                f"{agg['rounds']}, nps {agg['nps']}")
        # (c) the first loss against the in-process mesh of RANKS shards
        t0 = time.perf_counter()
        inproc = run_training(
            torch, Trainer(cfg.replace(mesh_shape=RANKS, synthetic=False,
                                       data_path=workdir,
                                       epochs=RANK_EPOCHS), dataset=ds),
            mesh_counts(dict(shards=RANKS, kinds=outs[0]["aggregate"]["kinds"],
                             halo=outs[0]["aggregate"]["halo"]),
                        RANK_EPOCHS, layers, False),
            f"train reddit, mesh {RANKS} in one process", RANK_EPOCHS)
        t_inproc = time.perf_counter() - t0
        statics = dict(shards=1, kinds=outs[0]["aggregate"]["kinds"],
                       halo=outs[0]["aggregate"]["halo"])
        counts = {}
        for dtype, bf16 in (("float32", False), ("bfloat16", True)):
            want = mesh_counts(statics, RANK_EPOCHS, layers, bf16)
            runs = [out[dtype] for out in outs]
            for r, run in enumerate(runs):
                losses = run["losses"]
                if (len(losses) != RANK_EPOCHS
                        or not all(map(math.isfinite, losses))):
                    raise AssertionError(f"ranks {dtype}: rank {r} losses "
                                         f"{losses}")
                # (g) launches a rank, exact
                if run["launches"] != want:
                    raise AssertionError(f"ranks {dtype}: rank {r} launches "
                                         f"{run['launches']} != {want}")
                c = run["collectives"]
                # (e) the exchange a layer, host staging included
                log(f"ranks {dtype}: rank {r} losses {losses}, steady epoch "
                    f"{run['steady_epoch_s']} s, CLI {run['cli_s']:.1f} s, "
                    f"peak memory {run['peak_gib']:.2f} GiB, exchange "
                    f"{c['exchange_ms'] / c['exchange_calls']:.3f} ms and "
                    f"{c['exchange_bytes'] // c['exchange_calls']} B a "
                    f"forward layer, {c['exchange_bwd_ms'] / c['exchange_bwd_calls']:.3f}"
                    f" ms and {c['exchange_bwd_bytes'] // c['exchange_bwd_calls']}"
                    f" B a backward layer, gradient all-reduce "
                    f"{c['grad_all_reduce_ms'] / c['grad_all_reduce_calls']:.3f}"
                    f" ms a step, launches {run['launches']} (exact) "
                    f"[{card}]")
            if runs[1]["losses"] != runs[0]["losses"]:
                raise AssertionError(f"ranks {dtype}: the ranks' losses "
                                     f"differ: {[r['losses'] for r in runs]}")
            counts[dtype] = [run["launches"] for run in runs]
        got, want_l = outs[0]["float32"]["losses"][0], inproc["losses"][0]
        rel = abs(got - want_l) / abs(want_l)
        if not rel <= 1e-5:
            raise AssertionError(f"ranks: first loss {got} vs {want_l} in "
                                 f"one process ({rel:.3e})")
        # (d) the steady epochs side by side
        log(f"ranks: first loss {got}, in-process mesh of {RANKS} {want_l} "
            f"({rel:.3e} relative); steady epoch f32 "
            f"{outs[0]['float32']['steady_epoch_s']} s on {RANKS} ranks, "
            f"{inproc['res']['steady_epoch_s']} s in one process "
            f"({inproc['peak_gib']:.2f} GiB peak), "
            f"{single['res']['steady_epoch_s']} s on one device (phase 5); "
            f"bfloat16 {outs[0]['bfloat16']['steady_epoch_s']} s on "
            f"{RANKS} ranks [{card}]")
        del inproc
        torch.cuda.empty_cache()
    log(f"phase ranks: {time.perf_counter() - t_phase:.1f} s ({t_ranks:.1f} "
        f"s the ranks, {t_inproc:.1f} s the in-process run) [{card}]")
    return counts


def main() -> int:
    t_main = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script measures the card",
              file=sys.stderr)
        return 1
    from spgemm_gnn_tpu_torch.graphs import native
    from spgemm_gnn_tpu_torch.graphs.csr import add_self_loops
    from spgemm_gnn_tpu_torch.graphs.datasets import load_dataset
    from spgemm_gnn_tpu_torch.kernels import _build, planned
    from spgemm_gnn_tpu_torch.kernels.planned import plan_graph
    from spgemm_gnn_tpu_torch.ops.norms import node_factors
    from spgemm_gnn_tpu_torch.train.config import TrainConfig
    from spgemm_gnn_tpu_torch.train.loop import Trainer
    from spgemm_gnn_tpu_torch.utils.device import resolve_device

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {time.perf_counter() - t0:.1f} s")

    # ---- Reddit: the windowed kind -----------------------------------------
    t0 = time.perf_counter()
    ds = load_dataset("reddit", allow_synthetic=True, data_path="/nonexistent",
                      synthetic_scale=SCALE, seed=SEED)
    t_reddit_build = time.perf_counter() - t0
    log(f"graph: reddit stand-in scale {SCALE}: N={ds.graph.num_nodes} "
        f"E={ds.graph.num_edges} features={ds.features.shape[1]} "
        f"classes={ds.num_classes}, host build {t_reddit_build:.1f} s, "
        f"native graph core {native.available()}")
    g = ds.graph = ds.graph.to(dev)
    if plan_graph(g).kind != "windowed":
        raise AssertionError("plan rule: reddit must take the windowed kind")
    log("plan: reddit takes the windowed kind (csr_spmm)")

    layers = 4
    kernels = maxk_phase(torch, g.num_nodes, HIDDEN, K, SEED, dev)
    torch.cuda.empty_cache()
    kernels16 = maxk16_phase(torch, g.num_nodes, HIDDEN, K, SEED, dev,
                             kernels)
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    xs = sparse_input(torch, g.num_nodes, HIDDEN, K, gen)
    gy = torch.randn((g.num_nodes, HIDDEN), generator=gen, device=dev)
    _, post = node_factors(g, "mean")
    csr_a = product_check(torch, "csr_spmm", g, xs, None, post)
    log_product("csr_spmm", "reddit, A, k-sparse x", csr_a)
    csr_t = product_check(torch, "csr_spmm", g, gy, post, None, transpose=True)
    log_product("csr_spmm", "reddit, A^T, dense g", csr_t)
    if not csr_a["nb"] > 1:
        raise AssertionError("csr_spmm on reddit: the rule gave one source "
                             "block")
    stream_reddit = product_check(torch, "stream_spmm", g, xs, None, post)
    log_product("stream_spmm", "reddit, A, k-sparse x; measure only",
                stream_reddit)
    # the 16-bit stream's form of the Reddit product, on the same inputs
    csr16_a = product16_check(torch, "csr_spmm", g, xs, None, post, csr_a)
    log_product16("csr_spmm", "reddit, A, k-sparse x", csr16_a)
    csr16_t = product16_check(torch, "csr_spmm", g, gy, post, None, csr_t,
                              transpose=True)
    log_product16("csr_spmm", "reddit, A^T, dense g", csr16_t)
    if not csr16_a["nb"] < csr_a["nb"]:
        raise AssertionError("csr_spmm_bf16 on reddit: bf16 rows did not "
                             "take fewer source blocks than f32 ones")
    # the 16-bit model's form: bf16 rows in, bf16 out
    csr16o_a = product16out_check(torch, "csr_spmm", g, xs, None, post)
    log_product16out("csr_spmm", "reddit, A, k-sparse x", csr16o_a)
    csr16o_t = product16out_check(torch, "csr_spmm", g, gy, post, None,
                                  transpose=True)
    log_product16out("csr_spmm", "reddit, A^T, dense g", csr16o_t)
    # B2's CBSR forms on the same k-sparse x: the MaxK forward's records,
    # at the dense bf16 form's schedule
    csr_cbsr16 = csr_cbsr16_check(torch, g, xs, post, False)
    csr_cbsr16o = csr_cbsr16_check(torch, g, xs, post, True)
    del xs, gy
    torch.cuda.empty_cache()
    # B2's 16-bit forms on MaxK's backward: the sampled backward on Aᵀ at
    # the dense bf16 form's schedule
    csr_sspmm16_entries = csr_sspmm16_check(torch, g, HIDDEN, K, SEED)
    torch.cuda.empty_cache()

    cfg = TrainConfig(dataset="reddit", model="sage", nonlinear="maxk",
                      maxk=K, hidden_dim=HIDDEN, hidden_layers=layers,
                      norm=True, dropout=0.5, w_lr=0.01, epochs=EPOCHS,
                      eval_every=1, seed=SEED, device="cuda",
                      impl="auto", synthetic=True,
                      synthetic_scale=SCALE)
    first_steps(torch, cfg, ds, "train reddit")
    # per epoch: a train step (forward + backward) and an eval forward
    reddit = run_training(torch, Trainer(cfg, dataset=ds), {
        "maxk_fwd": EPOCHS * 2 * layers, "maxk_bwd": EPOCHS * layers,
        "csr_spmm": EPOCHS * 3 * layers}, "train reddit")
    if not reddit["losses"][-1] < reddit["losses"][0]:
        raise AssertionError(f"train reddit: loss did not fall: "
                             f"{reddit['losses']}")
    reddit_counts = reddit["counts"]
    for entry in kernels:
        entry["launches"] = reddit_counts[entry["name"]]
        entry["launches_path"] = "train reddit"

    # the same recipe with the 16-bit stream: round_rows and the bf16
    # forms, no f32 aggregation launch; at the default rules the MaxK
    # forwards take csr_cbsr_spmm_bf16 on the compacted input's records
    # and the MaxK backwards csr_sspmm_bf16 on Aᵀ; then STREAM_CBSR_FORWARD
    # off (csr_spmm_bf16 forward, the backwards on their own rule), then
    # SAMPLED_BACKWARD off (csr_spmm_bf16 on Aᵀ): the same schedule, so the
    # same losses
    cfg16 = cfg.replace(stream="bf16x2")
    first_steps16(torch, cfg16, ds, "train reddit, bf16x2")
    dense16 = {"maxk_fwd": EPOCHS * 2 * layers, "maxk_bwd": EPOCHS * layers,
               "round_rows": EPOCHS * 3 * layers}
    cbsr_fwd16 = {"cbsr_compact": EPOCHS * 2 * layers,
                  "csr_cbsr_spmm_bf16": EPOCHS * 2 * layers}
    reddit16 = run_training(torch, Trainer(cfg16, dataset=ds), {
        **dense16, **cbsr_fwd16, "csr_sspmm_bf16": EPOCHS * layers},
        "train reddit, bf16x2")
    planned.STREAM_CBSR_FORWARD = False
    reddit16_off = run_training(torch, Trainer(cfg16, dataset=ds), {
        **dense16, "csr_spmm_bf16": EPOCHS * 2 * layers,
        "csr_sspmm_bf16": EPOCHS * layers},
        "train reddit, bf16x2, STREAM_CBSR_FORWARD off")
    planned.STREAM_CBSR_FORWARD = None
    planned.SAMPLED_BACKWARD = False
    reddit16_dense = run_training(torch, Trainer(cfg16, dataset=ds), {
        **dense16, **cbsr_fwd16, "csr_spmm_bf16": EPOCHS * layers},
        "train reddit, bf16x2, SAMPLED_BACKWARD off")
    planned.SAMPLED_BACKWARD = None
    planned.DEFAULT_STREAM = "f32"
    same_losses(reddit16, reddit16_off, "train reddit, bf16x2")
    bit_equal_losses(reddit16, reddit16_dense, "train reddit, bf16x2")
    log_against_dense("train reddit, bf16x2", reddit16, reddit16_dense,
                      reddit16_off)
    log(f"train reddit: steady epoch {reddit16['res']['steady_epoch_s']} s "
        f"with bf16x2 ({reddit16_dense['res']['steady_epoch_s']} s with "
        f"SAMPLED_BACKWARD off, {reddit16_off['res']['steady_epoch_s']} s "
        f"with STREAM_CBSR_FORWARD off), {reddit['res']['steady_epoch_s']} s "
        f"with f32")
    reddit16_counts = reddit16["counts"]
    reddit16_off_counts = reddit16_off["counts"]
    reddit16_dense_counts = reddit16_dense["counts"]

    # the 16-bit model (--dtype bfloat16): MaxK and the aggregation in their
    # bf16 forms only, no f32 aggregation launch and no round_rows; the
    # default rule, then the flag off
    cfg_b = cfg.replace(dtype="bfloat16")
    first_steps16(torch, cfg_b, ds, "train reddit, bfloat16", STEP_TOL16)
    dense_b = {"maxk_fwd_bf16": EPOCHS * 2 * layers,
               "maxk_bwd_bf16": EPOCHS * layers,
               "layer_norm16_fwd": EPOCHS * 2 * layers,
               "layer_norm16_bwd": EPOCHS * layers}
    cbsr_fwd_b = {"cbsr_compact_bf16": EPOCHS * 2 * layers,
                  "csr_cbsr_spmm_bf16_out": EPOCHS * 2 * layers}
    reddit_b = run_training(torch, Trainer(cfg_b, dataset=ds), {
        **dense_b, **cbsr_fwd_b, "csr_sspmm_bf16_out": EPOCHS * layers},
        "train reddit, bfloat16")
    require_fall(reddit_b, "train reddit, bfloat16")
    planned.STREAM_CBSR_FORWARD = False
    reddit_b_off = run_training(torch, Trainer(cfg_b, dataset=ds), {
        **dense_b, "csr_spmm_bf16_out": EPOCHS * 2 * layers,
        "csr_sspmm_bf16_out": EPOCHS * layers},
        "train reddit, bfloat16, STREAM_CBSR_FORWARD off")
    planned.STREAM_CBSR_FORWARD = None
    planned.SAMPLED_BACKWARD = False
    reddit_b_dense = run_training(torch, Trainer(cfg_b, dataset=ds), {
        **dense_b, **cbsr_fwd_b, "csr_spmm_bf16_out": EPOCHS * layers},
        "train reddit, bfloat16, SAMPLED_BACKWARD off")
    planned.SAMPLED_BACKWARD = None
    same_losses(reddit_b, reddit_b_off, "train reddit, bfloat16")
    bit_equal_losses(reddit_b, reddit_b_dense, "train reddit, bfloat16")
    log_against_dense("train reddit, bfloat16", reddit_b, reddit_b_dense,
                      reddit_b_off)
    log(f"train reddit: steady epoch {reddit_b['res']['steady_epoch_s']} s "
        f"with bfloat16 ({reddit_b_dense['res']['steady_epoch_s']} s with "
        f"SAMPLED_BACKWARD off, {reddit_b_off['res']['steady_epoch_s']} s "
        f"with STREAM_CBSR_FORWARD off; {reddit['res']['steady_epoch_s']} s "
        f"f32, {reddit16['res']['steady_epoch_s']} s bf16x2)")
    reddit_b_counts = reddit_b["counts"]
    reddit_b_off_counts = reddit_b_off["counts"]
    reddit_b_dense_counts = reddit_b_dense["counts"]
    del reddit16, reddit16_off, reddit16_dense, reddit_b
    del reddit_b_off, reddit_b_dense
    torch.cuda.empty_cache()

    # ---- the mesh: --mesh_shape 4 in one process on the Reddit recipe ------
    mesh = mesh_phase(torch, ds, cfg, reddit, card)
    torch.cuda.empty_cache()

    # ---- one graph shard a rank: the Reddit recipe over 2 processes -------
    ranks = ranks_phase(torch, ds, cfg, reddit, card)
    del reddit
    torch.cuda.empty_cache()

    # ---- timing and the benches on the Reddit recipe ------------------------
    bench_phase(torch, cfg, ds)
    del ds, g
    torch.cuda.empty_cache()

    for kind in ("windowed", "stream"):
        model_check(torch, SEED, kind)

    # ---- ogbn-products: the stream kind ------------------------------------
    t0 = time.perf_counter()
    ds2 = load_dataset("ogbn-products", allow_synthetic=True,
                       data_path="/nonexistent", synthetic_scale=SCALE,
                       seed=SEED)
    g2 = ds2.graph
    deg = g2.in_degrees
    log(f"graph 2: ogbn-products stand-in scale {SCALE}: N={g2.num_nodes} "
        f"E={g2.num_edges} features={ds2.features.shape[1]} "
        f"classes={ds2.num_classes}, median in-degree "
        f"{int(deg.median())}, max {int(deg.max())}, rows without in-edges "
        f"{int((deg == 0).sum())}, host build "
        f"{time.perf_counter() - t0:.1f} s, native graph core "
        f"{native.available()}")
    t0 = time.perf_counter()
    host_core_phase(torch, g2)
    log(f"phase host graph core: {time.perf_counter() - t0:.1f} s")
    g2 = ds2.graph = g2.to(dev)
    pg2 = plan_graph(g2)
    if pg2.kind != "stream":
        raise AssertionError("plan rule: ogbn-products must take the stream "
                             "kind")
    log(f"plan: ogbn-products takes the stream kind (stream_spmm): "
        f"{pg2.fwd_plan.num_chunks} chunks of {pg2.fwd_plan.chunk} edges, "
        f"{pg2.fwd_plan.carry_rows.numel()} carry rows")

    xs = sparse_input(torch, g2.num_nodes, HIDDEN, K, gen)
    gy = torch.randn((g2.num_nodes, HIDDEN), generator=gen, device=dev)
    _, post = node_factors(g2, "mean")
    stream_a = product_check(torch, "stream_spmm", g2, xs, None, post)
    log_product("stream_spmm", "products, A, k-sparse x", stream_a)
    stream_t = product_check(torch, "stream_spmm", g2, gy, post, None,
                             transpose=True)
    log_product("stream_spmm", "products, A^T, dense g", stream_t)
    csr_products = product_check(torch, "csr_spmm", g2, xs, None, post)
    if csr_products["nb"] != 1:
        raise AssertionError(f"csr_spmm on products: the rule gave "
                             f"{csr_products['nb']} source blocks, not 1")
    log_product("csr_spmm", "products, A, k-sparse x; measure only",
                csr_products)
    stream16_a = product16_check(torch, "stream_spmm", g2, xs, None, post,
                                 stream_a)
    log_product16("stream_spmm", "products, A, k-sparse x", stream16_a)
    stream16_t = product16_check(torch, "stream_spmm", g2, gy, post, None,
                                 stream_t, transpose=True)
    log_product16("stream_spmm", "products, A^T, dense g", stream16_t)
    stream16o_a = product16out_check(torch, "stream_spmm", g2, xs, None,
                                     post)
    log_product16out("stream_spmm", "products, A, k-sparse x", stream16o_a)
    stream16o_t = product16out_check(torch, "stream_spmm", g2, gy, post,
                                     None, transpose=True)
    log_product16out("stream_spmm", "products, A^T, dense g", stream16o_t)
    del xs, gy
    torch.cuda.empty_cache()
    # MaxK at the products recipe's shape, f32 and bf16 rows
    maxk_products = maxk_phase(torch, g2.num_nodes, HIDDEN, K, SEED, dev)
    torch.cuda.empty_cache()
    add_products(kernels[:2], maxk_products)
    add_products(kernels16, maxk16_phase(torch, g2.num_nodes, HIDDEN, K,
                                         SEED, dev, maxk_products))
    torch.cuda.empty_cache()
    round_entry = round_rows_check(torch, g2.num_nodes, HIDDEN, post, SEED)
    torch.cuda.empty_cache()
    cbsr_entry = stream_cbsr_check(torch, g2, HIDDEN, K, SEED)
    torch.cuda.empty_cache()
    cbsr16_entry = stream_cbsr16_check(torch, g2, HIDDEN, K, SEED, cbsr_entry)
    torch.cuda.empty_cache()
    cbsr16o_entry = stream_cbsr16out_check(torch, g2, HIDDEN, K, SEED)
    torch.cuda.empty_cache()
    sspmm16_entries = sspmm16_check(torch, g2, HIDDEN, K, SEED)
    torch.cuda.empty_cache()

    kernels.append(product_entry("csr_spmm", csr_a, csr_t,
                                 products_=csr_products))
    kernels[-1].update(launches=reddit_counts["csr_spmm"],
                       launches_path="train reddit")
    kernels += cbsr_phase(torch, pg2, HIDDEN, K, SEED)
    torch.cuda.empty_cache()
    cbsr16_entries = cbsr16_phase(torch, pg2, HIDDEN, K, SEED,
                                  {e["name"]: e for e in kernels})
    torch.cuda.empty_cache()
    compact16_entry = compact16_check(
        torch, g2.num_nodes, HIDDEN, K, SEED,
        next(e["ms"] for e in kernels if e["name"] == "cbsr_compact"))
    torch.cuda.empty_cache()
    norm16_entries = layer_norm16_check(torch, g2.num_nodes, HIDDEN, SEED)
    torch.cuda.empty_cache()

    layers2 = 3
    cfg2 = TrainConfig(dataset="ogbn-products", model="sage",
                       nonlinear="maxk", maxk=K, hidden_dim=HIDDEN,
                       hidden_layers=layers2, norm=True, dropout=0.5,
                       w_lr=0.003, epochs=EPOCHS, eval_every=1, seed=SEED,
                       device="cuda", impl="auto", synthetic=True,
                       synthetic_scale=SCALE)
    # the default (STREAM_CBSR_FORWARD None: the rule gives the MaxK
    # forward stream_cbsr_spmm at hidden 256), then the dense forward (the
    # flag off): the same losses
    first_steps(torch, cfg2, ds2, "train products")
    flag_on = {"maxk_fwd": EPOCHS * 2 * layers2, "maxk_bwd": EPOCHS * layers2,
               "cbsr_compact": EPOCHS * 2 * layers2,
               "stream_cbsr_spmm": EPOCHS * 2 * layers2,
               "stream_spmm": EPOCHS * layers2}
    products = run_training(torch, Trainer(cfg2, dataset=ds2), flag_on,
                            "train products")
    fell = products["losses"][-1] < products["losses"][0]
    log(f"train products: the loss {'fell' if fell else 'did not fall'} "
        f"over {EPOCHS} epochs at lr {cfg2.w_lr}")
    planned.STREAM_CBSR_FORWARD = False
    products_off = run_training(torch, Trainer(cfg2, dataset=ds2), {
        "maxk_fwd": EPOCHS * 2 * layers2, "maxk_bwd": EPOCHS * layers2,
        "stream_spmm": EPOCHS * 3 * layers2},
        "train products, STREAM_CBSR_FORWARD off")
    planned.STREAM_CBSR_FORWARD = None
    same_losses(products, products_off, "train products")
    log(f"train products: steady epoch {products['res']['steady_epoch_s']} "
        f"s default (stream_cbsr_spmm forward), "
        f"{products_off['res']['steady_epoch_s']} s off")
    for entry in kernels[:2]:
        entry["products_launches"] = products["counts"][entry["name"]]
    stream_entry = product_entry("stream_spmm", stream_a, stream_t,
                                 reddit_=stream_reddit)
    stream_entry.update(
        launches=products["counts"]["stream_spmm"],
        launches_path="train products",
        flag_off_launches=products_off["counts"]["stream_spmm"])
    kernels.insert(3, stream_entry)
    cbsr_entry.update(launches=products["counts"]["stream_cbsr_spmm"],
                      launches_path="train products")
    kernels.insert(4, cbsr_entry)
    del products, products_off
    torch.cuda.empty_cache()

    # the products recipe with the 16-bit stream: the default (the MaxK
    # forwards on B8, the MaxK backwards on stream_sspmm_bf16), then
    # STREAM_CBSR_FORWARD off (stream_spmm_bf16 forward; the backwards keep
    # their own rule), then SAMPLED_BACKWARD off (stream_spmm_bf16 on Aᵀ):
    # the same losses, the last bit for bit
    cfg2_16 = cfg2.replace(stream="bf16x2")
    first_steps16(torch, cfg2_16, ds2, "train products, bf16x2")
    msgs16 = {"maxk_fwd": EPOCHS * 2 * layers2, "maxk_bwd": EPOCHS * layers2,
              "round_rows": EPOCHS * 3 * layers2}
    cbsr16 = {"cbsr_compact": EPOCHS * 2 * layers2,
              "stream_cbsr_spmm_bf16": EPOCHS * 2 * layers2}
    products16 = run_training(torch, Trainer(cfg2_16, dataset=ds2), {
        **msgs16, **cbsr16, "stream_sspmm_bf16": EPOCHS * layers2},
        "train products, bf16x2")
    planned.STREAM_CBSR_FORWARD = False
    first_steps16(torch, cfg2_16, ds2,
                  "train products, bf16x2, STREAM_CBSR_FORWARD off")
    products16_off = run_training(torch, Trainer(cfg2_16, dataset=ds2), {
        **msgs16, "stream_spmm_bf16": EPOCHS * 2 * layers2,
        "stream_sspmm_bf16": EPOCHS * layers2},
        "train products, bf16x2, STREAM_CBSR_FORWARD off")
    planned.STREAM_CBSR_FORWARD = None
    planned.SAMPLED_BACKWARD = False
    products16_dense = run_training(torch, Trainer(cfg2_16, dataset=ds2), {
        **msgs16, **cbsr16, "stream_spmm_bf16": EPOCHS * layers2},
        "train products, bf16x2, SAMPLED_BACKWARD off")
    planned.SAMPLED_BACKWARD = None
    planned.DEFAULT_STREAM = "f32"
    same_losses(products16, products16_off, "train products, bf16x2")
    bit_equal_losses(products16, products16_dense, "train products, bf16x2")
    log_against_dense("train products, bf16x2", products16,
                      products16_dense, products16_off)
    products16_counts = products16["counts"]
    products16_off_counts = products16_off["counts"]
    products16_dense_counts = products16_dense["counts"]
    del products16, products16_off, products16_dense
    torch.cuda.empty_cache()

    # the products recipe as the 16-bit model, default then flag off
    cfg2_b = cfg2.replace(dtype="bfloat16")
    first_steps16(torch, cfg2_b, ds2, "train products, bfloat16", STEP_TOL16)
    norm16 = {"layer_norm16_fwd": EPOCHS * 2 * layers2,
              "layer_norm16_bwd": EPOCHS * layers2}
    maxk16 = {"maxk_fwd_bf16": EPOCHS * 2 * layers2,
              "maxk_bwd_bf16": EPOCHS * layers2, **norm16}
    fwd16 = {"cbsr_compact_bf16": EPOCHS * 2 * layers2,
             "stream_cbsr_spmm_bf16_out": EPOCHS * 2 * layers2}
    flag_on16 = {**maxk16, **fwd16,
                 "stream_sspmm_bf16_out": EPOCHS * layers2}
    dense_bwd16 = {**maxk16, **fwd16,
                   "stream_spmm_bf16_out": EPOCHS * layers2}
    products_b = run_training(torch, Trainer(cfg2_b, dataset=ds2), flag_on16,
                              "train products, bfloat16")
    require_fall(products_b, "train products, bfloat16")
    planned.STREAM_CBSR_FORWARD = False
    first_steps16(torch, cfg2_b, ds2,
                  "train products, bfloat16, STREAM_CBSR_FORWARD off",
                  STEP_TOL16)
    products_b_off = run_training(torch, Trainer(cfg2_b, dataset=ds2), {
        **maxk16, "stream_spmm_bf16_out": EPOCHS * 2 * layers2,
        "stream_sspmm_bf16_out": EPOCHS * layers2},
        "train products, bfloat16, STREAM_CBSR_FORWARD off")
    planned.STREAM_CBSR_FORWARD = None
    require_fall(products_b_off, "train products, bfloat16, flag off")
    planned.SAMPLED_BACKWARD = False
    products_b_dense = run_training(
        torch, Trainer(cfg2_b, dataset=ds2), dense_bwd16,
        "train products, bfloat16, SAMPLED_BACKWARD off")
    planned.SAMPLED_BACKWARD = None
    same_losses(products_b, products_b_off, "train products, bfloat16")
    bit_equal_losses(products_b, products_b_dense, "train products, bfloat16")
    log_against_dense("train products, bfloat16", products_b,
                      products_b_dense, products_b_off)
    products_b_counts = products_b["counts"]
    products_b_off_counts = products_b_off["counts"]
    products_b_dense_counts = products_b_dense["counts"]
    del products_b, products_b_off, products_b_dense
    torch.cuda.empty_cache()

    # ---- train 3: the products recipe with GCN and self-loops (default) ---
    t0 = time.perf_counter()
    ds3 = dataclasses.replace(ds2, graph=add_self_loops(g2))
    log(f"graph 3: ogbn-products stand-in with self-loops: "
        f"E={ds3.graph.num_edges}, host build {time.perf_counter() - t0:.1f} s")
    if plan_graph(ds3.graph).kind != "stream":
        raise AssertionError("plan rule: ogbn-products with self-loops must "
                             "take the stream kind")
    cfg3 = cfg2.replace(model="gcn", selfloop=True)
    first_steps(torch, cfg3, ds3, "train 3 (GCN)")
    gcn = run_training(torch, Trainer(cfg3, dataset=ds3), flag_on,
                       "train 3 (GCN, products, self-loops)")
    cbsr_entry.update(gcn_launches=gcn["counts"]["stream_cbsr_spmm"])
    del gcn
    torch.cuda.empty_cache()
    # the same as the 16-bit model: GCN has both node factors, so its bf16
    # pre-scale and post epilogue run here
    cfg3_b = cfg3.replace(dtype="bfloat16")
    first_steps16(torch, cfg3_b, ds3, "train 3 (GCN), bfloat16", STEP_TOL16)
    gcn_b = run_training(torch, Trainer(cfg3_b, dataset=ds3), flag_on16,
                         "train 3 (GCN, products, self-loops), bfloat16")
    require_fall(gcn_b, "train 3 (GCN), bfloat16")
    planned.SAMPLED_BACKWARD = False
    gcn_b_dense = run_training(
        torch, Trainer(cfg3_b, dataset=ds3), dense_bwd16,
        "train 3 (GCN, products, self-loops), bfloat16, SAMPLED_BACKWARD off")
    planned.SAMPLED_BACKWARD = None
    bit_equal_losses(gcn_b, gcn_b_dense, "train 3 (GCN), bfloat16")
    log_against_dense("train 3 (GCN), bfloat16", gcn_b, gcn_b_dense)
    gcn_b_counts = gcn_b["counts"]
    del gcn_b, gcn_b_dense, ds3
    torch.cuda.empty_cache()

    # the 16-bit stream's kernels
    kernels.append(entry16(
        "csr_spmm_bf16", "spgemm_gnn_tpu_torch/csrc/spmm.cu",
        "spgemm_gnn_tpu/kernels/spgemm_pallas.py:97 (packed branch "
        ":124-129, :183-186)", csr16_a, csr16_t))
    # at the default the MaxK forwards take csr_cbsr_spmm_bf16 and the
    # MaxK backwards csr_sspmm_bf16: this form runs on the paths with
    # either flag off
    kernels[-1].update(
        launches=reddit16_dense_counts["csr_spmm_bf16"],
        launches_path="train reddit, bf16x2, SAMPLED_BACKWARD off",
        default_launches=reddit16_counts.get("csr_spmm_bf16", 0),
        flag_off_launches=reddit16_off_counts["csr_spmm_bf16"])
    csr_cbsr16.update(launches=reddit16_counts["csr_cbsr_spmm_bf16"],
                      launches_path="train reddit, bf16x2")
    kernels.append(csr_cbsr16)
    csr_sspmm16_entries[0].update(
        launches=reddit16_counts["csr_sspmm_bf16"],
        launches_path="train reddit, bf16x2",
        flag_off_launches=reddit16_off_counts["csr_sspmm_bf16"])
    kernels.append(csr_sspmm16_entries[0])
    kernels.append(entry16(
        "stream_spmm_bf16", "spgemm_gnn_tpu_torch/csrc/stream.cu",
        "spgemm_gnn_tpu/kernels/stream_pallas.py:37 (bf16 stream, "
        ":227-228)", stream16_a, stream16_t))
    # at the default the MaxK backwards take stream_sspmm_bf16: this form
    # runs on the paths with either flag off
    kernels[-1].update(
        launches=products16_dense_counts["stream_spmm_bf16"],
        launches_path="train products, bf16x2, SAMPLED_BACKWARD off",
        default_launches=products16_counts.get("stream_spmm_bf16", 0),
        flag_off_launches=products16_off_counts["stream_spmm_bf16"])
    sspmm16_entries[0].update(
        launches=products16_counts["stream_sspmm_bf16"],
        launches_path="train products, bf16x2",
        flag_off_launches=products16_off_counts["stream_sspmm_bf16"])
    kernels.append(sspmm16_entries[0])
    cbsr16_entry.update(
        launches=products16_counts["stream_cbsr_spmm_bf16"],
        launches_path="train products, bf16x2")
    kernels.append(cbsr16_entry)
    round_entry.update(launches=products16_counts["round_rows"],
                       launches_path="train products, bf16x2")
    kernels.append(round_entry)

    # the 16-bit model's kernels
    for entry in kernels16:
        entry.update(launches=reddit_b_counts[entry["name"]],
                     launches_path="train reddit, bfloat16",
                     products_launches=products_b_counts[entry["name"]])
    kernels += kernels16
    kernels.append(entry16(
        "csr_spmm_bf16_out", "spgemm_gnn_tpu_torch/csrc/spmm.cu",
        "spgemm_gnn_tpu/kernels/spgemm_pallas.py:97 (bf16 output: "
        "planned.py:271-274, :300)", csr16o_a, csr16o_t))
    kernels[-1].update(
        launches=reddit_b_dense_counts["csr_spmm_bf16_out"],
        launches_path="train reddit, bfloat16, SAMPLED_BACKWARD off",
        default_launches=reddit_b_counts.get("csr_spmm_bf16_out", 0),
        flag_off_launches=reddit_b_off_counts["csr_spmm_bf16_out"])
    csr_cbsr16o.update(launches=reddit_b_counts["csr_cbsr_spmm_bf16_out"],
                       launches_path="train reddit, bfloat16")
    kernels.append(csr_cbsr16o)
    csr_sspmm16_entries[1].update(
        launches=reddit_b_counts["csr_sspmm_bf16_out"],
        launches_path="train reddit, bfloat16",
        flag_off_launches=reddit_b_off_counts["csr_sspmm_bf16_out"])
    kernels.append(csr_sspmm16_entries[1])
    kernels.append(entry16(
        "stream_spmm_bf16_out", "spgemm_gnn_tpu_torch/csrc/stream.cu",
        "spgemm_gnn_tpu/kernels/stream_pallas.py:37 (out_dtype, :217-242)",
        stream16o_a, stream16o_t))
    kernels[-1].update(
        launches=products_b_dense_counts["stream_spmm_bf16_out"],
        launches_path="train products, bfloat16, SAMPLED_BACKWARD off",
        default_launches=products_b_counts.get("stream_spmm_bf16_out", 0),
        flag_off_launches=products_b_off_counts["stream_spmm_bf16_out"])
    sspmm16_entries[1].update(
        launches=products_b_counts["stream_sspmm_bf16_out"],
        launches_path="train products, bfloat16",
        flag_off_launches=products_b_off_counts["stream_sspmm_bf16_out"],
        gcn_launches=gcn_b_counts["stream_sspmm_bf16_out"])
    kernels.append(sspmm16_entries[1])
    cbsr16o_entry.update(
        launches=products_b_counts["stream_cbsr_spmm_bf16_out"],
        launches_path="train products, bfloat16")
    compact16_entry.update(
        launches=products_b_counts["cbsr_compact_bf16"],
        launches_path="train products, bfloat16")
    kernels += [cbsr16o_entry, compact16_entry]
    for entry in norm16_entries:
        entry.update(launches=products_b_counts[entry["name"]],
                     launches_path="train products, bfloat16")
    kernels += norm16_entries

    kernels += cbsr16_entries

    # ---- serve: checkpoints, resume, --evaluate, predict requests ---------
    with tempfile.TemporaryDirectory() as workdir:
        serve_phase(torch, cfg2, ds2, workdir)
    del pg2
    torch.cuda.empty_cache()

    # ---- --remat and the plan cache on products ----------------------------
    t0 = time.perf_counter()
    remat_phase(torch, cfg2, ds2)
    log(f"phase remat: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as workdir:
        plan_cache_phase(torch, g2, "products f32", torch.float32, workdir)
        plan_cache_phase(torch, g2, "products bf16", torch.bfloat16,
                         workdir)
        del ds2, g2
        torch.cuda.empty_cache()
        log(f"phase plan cache (products): {time.perf_counter() - t0:.1f} s")

        # ---- --device_inputs, the plan cache and remat on Reddit -----------
        t0 = time.perf_counter()
        ds_r = device_inputs_phase(torch, cfg, t_reddit_build)
        log(f"phase device inputs: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        g_r = ds_r.graph.to(dev)
        plan_cache_phase(torch, g_r, "reddit f32", torch.float32, workdir)
        log(f"phase plan cache (reddit): {time.perf_counter() - t0:.1f} s")
    remat_graph_check(cfg, ds_r)
    del ds_r, g_r
    torch.cuda.empty_cache()

    # ---- ogbn-proteins: ROC-AUC ---------------------------------------------
    t0 = time.perf_counter()
    proteins_counts = proteins_phase(torch)
    log(f"phase proteins: {time.perf_counter() - t0:.1f} s")
    for entry in kernels:
        for run, counts in proteins_counts.items():
            if entry["name"] in counts:
                entry["proteins_launches"] = counts[entry["name"]]
                entry["proteins_launches_path"] = (
                    "train proteins" + (", bfloat16" if run == "bfloat16"
                                        else ""))

    # the mesh path's launches (phase 5a) and B2's per-role times there
    for entry in kernels:
        for run, key in (("f32", "mesh_launches"),
                         ("bfloat16", "mesh_bf16_launches")):
            if entry["name"] in mesh["counts"][run]:
                entry[key] = mesh["counts"][run][entry["name"]]
                entry[key + "_path"] = ("train reddit, mesh 4" + (
                    ", bfloat16" if run == "bfloat16" else ""))
        if entry["name"] in mesh["sweep_counts"]:
            entry["mesh_sweep_launches"] = mesh["sweep_counts"][entry["name"]]
        kind = {"csr_spmm": "windowed", "stream_spmm": "stream"}.get(
            entry["name"])
        roles = {role: [r["ms"] for r in r_all["shards"]
                        if r["stream"] == "f32"]
                 for role, r_all in mesh["roles"].items()
                 if r_all["kind"] == kind}
        if roles:
            entry["mesh_role_ms"] = roles
        # phase 5c: each rank's launches (rank 0, rank 1)
        for run, key in (("float32", "ranks_launches"),
                         ("bfloat16", "ranks_bf16_launches")):
            if entry["name"] in ranks[run][0]:
                entry[key] = [c[entry["name"]] for c in ranks[run]]
                entry[key + "_path"] = (f"train reddit, {RANKS} ranks" + (
                    ", bfloat16" if run == "bfloat16" else ""))

    # ---- the 80-epoch accuracy check, f32 and bf16x2 ----------------------
    accuracy_check(torch)

    log(f"chip_smoke wall time: {time.perf_counter() - t_main:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--rank"]:
        sys.exit(rank_main(sys.argv[1:]))
    sys.exit(main())
