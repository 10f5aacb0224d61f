"""Plan disk cache (counterpart of `spgemm_gnn_tpu/graphs/plan_cache.py`):
a graph's plans are built once and reused across runs, keyed by a content
fingerprint of the CSR plus every parameter that changes a plan.

What a file holds is what the port's plans derive from the CSR, never the
CSR itself (a loaded plan takes the graph's own `indptr` and `indices`
tensors, so nothing is held twice):
- a windowed plan (`CSRPlan`): each `CSRSchedule` it has built (the
  re-bucketed sources, the block row pointers, the segments and fix-ups,
  the passes' offsets) and each `RecordWalk` built over it (the entries,
  runs and offsets of `csr_cbsr_spmm`'s record passes);
- a stream plan (`StreamPlan`): its chunk rows and carry rows, and what it
  keeps in `_hot`: the gather order, each `HotSet`, and the transpose
  positions.

One `.npz` a plan, written to a temporary name and renamed, so a reader
never sees half a file; a file that does not load (corrupt or partial) is
deleted and the plan rebuilt, as the reference does. A loaded plan lands on
the device of the CSR it is given, its passes' offsets on the host as
built.

A sharded host build (parallel/planned_sharded.py::_shard_host: each
role's per-shard CSRs, the send schedule and the statics) is a directory of
`.npy` files and a `meta.json` (`save_shard_host`), loaded as memory maps
(`load_shard_host`), the reference's layout; `cached_shard_host` loads or
builds and stores it under the reference's key, and deletes an entry that
does not load before it rebuilds.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
from typing import Callable

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs.stream_tiles import HotSet, StreamPlan
from spgemm_gnn_tpu_torch.graphs.tiles import (CSRPlan, CSRSchedule,
                                               RecordWalk)

# bump when a rule that shapes a port plan changes without a parameter in
# the key saying so (the source-block rule, the segment order, the hot
# set's tie order, ...): a key carries the parameters, not the rules
PLANNER_VERSION = 2


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def graph_fingerprint(indptr, indices) -> str:
    """Stable fingerprint of a CSR structure (its content, not its
    identity): the JAX package's hex string for the same CSR."""
    h = hashlib.blake2b(digest_size=16)
    a = np.ascontiguousarray(_host(indptr).astype(np.int64, copy=False))
    b = np.ascontiguousarray(_host(indices).astype(np.int32, copy=False))
    h.update(np.int64(a.shape[0]).tobytes())
    h.update(np.int64(b.shape[0]).tobytes())
    h.update(a.tobytes())
    h.update(b.tobytes())
    return h.hexdigest()


def plan_key(fingerprint: str, direction: str, kind: str, **params) -> str:
    """Deterministic cache key from the fingerprint, the direction ("f" or
    "t"), the plan kind and the parameters (None ones left out)."""
    tail = "_".join(f"{k}{params[k]}" for k in sorted(params)
                    if params[k] is not None)
    head = f"{fingerprint}_v{PLANNER_VERSION}_{direction}_{kind}"
    return f"{head}_{tail}" if tail else head


def _windowed_parts(plan: CSRPlan) -> tuple[dict, dict]:
    statics = {"kind": "windowed", "src_blocks": plan.src_blocks,
               "segment": plan.segment, "num_src": plan.num_src,
               "schedules": []}
    arrays = {}
    for i, ((nb, n_src), s) in enumerate(plan._schedules.items()):
        shares = s.indices.data_ptr() == plan.indices.data_ptr()
        statics["schedules"].append(dict(
            nb=nb, n_src=n_src, block_rows=s.block_rows, segment=s.segment,
            n_slots=s.n_slots, shares_csr=shares,
            walks=[dict(group=w.group, passes=w.passes, n_slots=w.n_slots)
                   for w in s._walks.values()]))
        fields = ["seg", "fix", "pass_seg", "pass_fix"]
        if not shares:
            fields += ["indices", "block_indptr"]
        for f in fields:
            arrays[f"s{i}_{f}"] = _host(getattr(s, f))
        for w in s._walks.values():
            for f in ("entries", "runs", "offsets"):
                arrays[f"s{i}_w{w.group}_{f}"] = _host(getattr(w, f))
    return statics, arrays


def _stream_parts(plan: StreamPlan) -> tuple[dict, dict]:
    statics = {"kind": "stream", "chunk": plan.chunk,
               "warp_chunks": plan.warp_chunks, "num_src": plan.num_src,
               "hot": [],
               "order": "order" in plan._hot,
               "positions": "positions" in plan._hot}
    arrays = {"chunk_row0": _host(plan.chunk_row0),
              "carry_rows": _host(plan.carry_rows)}
    if statics["order"]:
        ids, counts = plan._hot["order"]
        arrays.update(order_ids=_host(ids), order_counts=_host(counts))
    if statics["positions"]:
        arrays["positions"] = _host(plan._hot["positions"])
    hot = [h for key, h in plan._hot.items() if isinstance(key, tuple)]
    for i, h in enumerate(hot):
        statics["hot"].append(dict(rows=h.rows, row_bytes=h.row_bytes,
                                   budget=h.budget, edge_share=h.edge_share,
                                   mask=h.mask is not None))
        if h.mask is not None:
            arrays[f"h{i}_mask"] = _host(h.mask)
    return statics, arrays


def save_plan(path: str, plan: CSRPlan | StreamPlan) -> None:
    """Write what `plan` derives from its CSR to one `.npz` at `path`."""
    if isinstance(plan, StreamPlan):
        statics, arrays = _stream_parts(plan)
    elif isinstance(plan, CSRPlan):
        statics, arrays = _windowed_parts(plan)
    else:
        raise TypeError(f"no cache form for {type(plan).__name__}")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp.npz"   # savez keeps a .npz suffix
    np.savez(tmp, __statics__=json.dumps(statics), **arrays)
    os.replace(tmp, path)


def load_plan(path: str, indptr: torch.Tensor,
              indices: torch.Tensor) -> CSRPlan | StreamPlan:
    """The plan saved at `path` over the CSR (indptr, indices), which must
    be the one it was built on, on that CSR's device."""
    dev = indptr.device
    with np.load(path, allow_pickle=False) as z:
        statics = json.loads(str(z["__statics__"]))

        def t(name, device=dev):
            return torch.from_numpy(z[name]).to(device)

        if statics["kind"] == "stream":
            plan = StreamPlan(indptr=indptr, indices=indices,
                              chunk_row0=t("chunk_row0"),
                              carry_rows=t("carry_rows"),
                              chunk=statics["chunk"],
                              warp_chunks=statics["warp_chunks"],
                              num_src=statics["num_src"])
            if statics["order"]:
                plan._hot["order"] = (t("order_ids"), t("order_counts"))
            if statics["positions"]:
                plan._hot["positions"] = t("positions")
            for i, h in enumerate(statics["hot"]):
                mask = t(f"h{i}_mask") if h.pop("mask") else None
                plan._hot[(h["row_bytes"], h["budget"])] = HotSet(
                    mask=mask, **h)
            return plan
        plan = CSRPlan(indptr, indices, src_blocks=statics["src_blocks"],
                       segment=statics["segment"], num_src=statics["num_src"])
        for i, s in enumerate(statics["schedules"]):
            if s["shares_csr"]:
                ix, bptr = indices, indptr[None]
            else:
                ix, bptr = t(f"s{i}_indices"), t(f"s{i}_block_indptr")
            sched = plan._schedules[(s["nb"], s["n_src"])] = CSRSchedule(
                nb=s["nb"], block_rows=s["block_rows"],
                segment=s["segment"], indices=ix, block_indptr=bptr,
                seg=t(f"s{i}_seg"), fix=t(f"s{i}_fix"),
                pass_seg=t(f"s{i}_pass_seg", "cpu"),
                pass_fix=t(f"s{i}_pass_fix", "cpu"), n_slots=s["n_slots"])
            for w in s["walks"]:
                at = f"s{i}_w{w['group']}"
                sched._walks[w["group"]] = RecordWalk(
                    entries=t(f"{at}_entries"), runs=t(f"{at}_runs"),
                    offsets=t(f"{at}_offsets", "cpu"), **w)
        return plan


def cached_plan(cache_dir: str | None, key: str,
                builder: Callable[[], CSRPlan | StreamPlan],
                indptr: torch.Tensor, indices: torch.Tensor
                ) -> CSRPlan | StreamPlan:
    """The plan of `key` loaded from cache_dir over (indptr, indices), or
    built by `builder` and stored. A file that does not load is deleted
    and the plan rebuilt; a store that fails leaves the built plan."""
    if not cache_dir:
        return builder()
    path = os.path.join(cache_dir, f"plan_{key}.npz")
    if os.path.exists(path):
        try:
            return load_plan(path, indptr, indices)
        except Exception:
            try:
                os.remove(path)
            except OSError:
                pass
    plan = builder()
    try:
        save_plan(path, plan)
    except OSError:
        pass
    return plan


def save_shard_host(path: str, host: dict) -> None:
    """Write a sharded host build to the directory `path` (a temporary
    directory renamed into place): one `.npy` per array and `meta.json`
    for the statics, the roles' kinds and the alias marker."""
    tmp = f"{path}.{os.getpid()}.tmp"
    os.makedirs(tmp, exist_ok=True)
    meta = {"statics": host["statics"], "roles": {},
            "n_send": len(host["send_idx"])}
    for name, role in host["roles"].items():
        if role is None or isinstance(role, str):   # absent, or the alias
            meta["roles"][name] = role
            continue
        meta["roles"][name] = {"kind": role["kind"],
                               "statics": role["statics"],
                               "arrays": sorted(role["arrays"])}
        for f, a in role["arrays"].items():
            np.save(os.path.join(tmp, f"{name}__{f}.npy"), a)
    for i, a in enumerate(host["send_idx"]):
        np.save(os.path.join(tmp, f"send{i}.npy"), a)
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump(meta, fh)
    if os.path.isdir(path):
        shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)


def load_shard_host(path: str) -> dict:
    """The sharded host build saved at `path`, its arrays memory-mapped."""
    with open(os.path.join(path, "meta.json")) as fh:
        meta = json.load(fh)

    def mm(name):
        return np.load(os.path.join(path, name + ".npy"), mmap_mode="r")

    roles = {}
    for name, r in meta["roles"].items():
        if r is None or isinstance(r, str):
            roles[name] = r
            continue
        roles[name] = {"kind": r["kind"], "statics": r["statics"],
                       "arrays": {f: mm(f"{name}__{f}")
                                  for f in r["arrays"]}}
    return {"roles": roles,
            "send_idx": [mm(f"send{i}") for i in range(meta["n_send"])],
            "statics": meta["statics"]}


def cached_shard_host(cache_dir: str | None, key: str,
                      builder: Callable[[], dict]) -> dict:
    """The sharded host build of `key` loaded from cache_dir, or built by
    `builder` and stored. An entry that does not load is deleted and
    rebuilt; a store that fails leaves the built one."""
    if not cache_dir:
        return builder()
    path = os.path.join(cache_dir, f"shard_{key}")
    if os.path.isdir(path):
        try:
            return load_shard_host(path)
        except Exception:
            shutil.rmtree(path, ignore_errors=True)
    host = builder()
    try:
        save_shard_host(path, host)
    except OSError:
        pass
    return host
