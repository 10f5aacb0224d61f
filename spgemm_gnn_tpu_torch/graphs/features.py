"""Feature stores (counterpart of `spgemm_gnn_tpu/graphs/features.py`).

Rows of node features are fetched by node id, for computations that touch a
subset of the nodes (`train/infer.py::predict_nodes`):

- `DeviceFeatureStore`: every row on the device; a fetch is one gather.
- `HostFeatureStore(policy=...)`: the rows in pinned host memory (f32), and
  a device cache of `int(num_nodes * cache_ratio)` rows, one `[capacity,
  dim]` tensor. Policies:
    * "direct"      — no cache; every fetch copies its rows from the host;
    * "static-outd" — the rows of the highest out-degree nodes, loaded once
                      and never evicted;
    * "fifo" / "lru" — rows admitted on a miss, the oldest admitted / least
                      recently fetched evicted first.

The bookkeeping is the JAX package's, flat numpy tables with no per-id
Python loop (`_slot_table` node → slot, `_resident` slot → node, `_stamp`
per slot), so the slots, the evictions and the hit and miss counts are the
same numbers for the same fetches. A fetch does one host gather of its
misses into pinned memory, one `non_blocking` copy to the device, and
merges them with the cached rows there; the rows come back on the store's
device in its dtype (f32 on the host, cast on the device). "fifo" and
"lru" admit the missed rows from that device copy, where the JAX store
gathers and transfers them a second time, so their `bytes_from_host` is the
JAX store's less those second transfers.
"""
from __future__ import annotations

import numpy as np
import torch

POLICIES = ("direct", "static-outd", "fifo", "lru")


def _ids(node_ids) -> np.ndarray:
    if isinstance(node_ids, torch.Tensor):
        node_ids = node_ids.cpu().numpy()
    return np.asarray(node_ids).ravel().astype(np.int64, copy=False)


class FeatureStore:
    """Common interface: `full()` for the full-graph paths, `fetch(ids)` for
    subsets, and hit / miss statistics."""

    num_nodes: int
    dim: int

    def full(self) -> torch.Tensor:
        raise NotImplementedError

    def fetch(self, node_ids) -> torch.Tensor:
        raise NotImplementedError

    @property
    def stats(self) -> dict:
        return {"hits": 0, "misses": 0, "hit_rate": 0.0}

    def reset_stats(self) -> None:
        pass


class DeviceFeatureStore(FeatureStore):
    """All rows on `device` in `dtype` (a tensor already there is kept, not
    copied)."""

    def __init__(self, features, dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        self._x = torch.as_tensor(features, dtype=dtype, device=device)
        self.num_nodes, self.dim = self._x.shape

    def full(self) -> torch.Tensor:
        return self._x

    def fetch(self, node_ids) -> torch.Tensor:
        idx = torch.from_numpy(_ids(node_ids)).to(self._x.device)
        return self._x.index_select(0, idx)


class HostFeatureStore(FeatureStore):
    """Host rows with a device cache of hot rows (module docstring)."""

    def __init__(self, features, *, policy: str = "static-outd",
                 cache_ratio: float = 0.05, out_degrees=None,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device = "cuda"):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}")
        self.device = torch.device(device)
        host = torch.from_numpy(np.ascontiguousarray(features, np.float32))
        self._pin = self.device.type == "cuda"
        self._host = host.pin_memory() if self._pin else host
        self.num_nodes, self.dim = self._host.shape
        self._dtype = dtype
        self.policy = policy
        self.capacity = int(self.num_nodes * cache_ratio)
        self._hits = 0
        self._misses = 0
        self._slot_table = np.full(self.num_nodes, -1, np.int32)
        self._resident = np.full(max(self.capacity, 1), -1, np.int64)
        self._stamp = np.zeros(max(self.capacity, 1), np.int64)
        self._clock = 1
        self._cache_dev: torch.Tensor | None = None
        self.bytes_from_host = 0
        if policy == "static-outd":
            if out_degrees is None:
                raise ValueError("static-outd policy needs out_degrees")
            if isinstance(out_degrees, torch.Tensor):
                out_degrees = out_degrees.cpu().numpy()
            top = np.argsort(-np.asarray(out_degrees), kind="stable")
            top = top[: self.capacity]
            self._slot_table[top] = np.arange(len(top), dtype=np.int32)
            if self.capacity > 0:
                # one start-up transfer of the pinned hot rows
                self._cache_dev = self._to_device(self._gather(top, False))
        elif policy in ("fifo", "lru") and self.capacity > 0:
            self._cache_dev = torch.zeros((self.capacity, self.dim),
                                          dtype=dtype, device=self.device)

    # -- stats ---------------------------------------------------------------
    @property
    def stats(self) -> dict:
        total = self._hits + self._misses
        return {"hits": self._hits, "misses": self._misses,
                "hit_rate": self._hits / total if total else 0.0,
                "bytes_from_host": self.bytes_from_host}

    def reset_stats(self) -> None:
        self._hits = 0
        self._misses = 0
        self.bytes_from_host = 0

    # -- transfers -----------------------------------------------------------
    def _gather(self, ids: np.ndarray, count: bool = True) -> torch.Tensor:
        """The host rows of `ids` (f32), in pinned memory on a CUDA store;
        with `count`, their bytes are added to `bytes_from_host`."""
        idx = torch.from_numpy(np.asarray(ids, np.int64))
        out = torch.empty((idx.numel(), self.dim), dtype=torch.float32,
                          pin_memory=self._pin)
        torch.index_select(self._host, 0, idx, out=out)
        if count:
            self.bytes_from_host += out.numel() * out.element_size()
        return out

    def _to_device(self, rows: torch.Tensor) -> torch.Tensor:
        return rows.to(self.device, non_blocking=True).to(self._dtype)

    def _index(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.asarray(a, np.int64)).to(
            self.device, non_blocking=True)

    # -- fetch ---------------------------------------------------------------
    def full(self) -> torch.Tensor:
        """Every row, copied to the device (no cache: use fetch for
        subsets)."""
        return self._host.to(self.device).to(self._dtype)

    def fetch(self, node_ids) -> torch.Tensor:
        ids = _ids(node_ids)
        if ids.size == 0:
            return torch.zeros((0, self.dim), dtype=self._dtype,
                               device=self.device)
        if self.policy == "direct" or self.capacity == 0:
            self._misses += len(ids)
            return self._to_device(self._gather(ids))

        # hits come from the device cache; only the misses cross from the
        # host
        slots = self._slot_table[ids].astype(np.int64)
        hit = slots >= 0
        self._hits += int(hit.sum())
        self._misses += int((~hit).sum())
        out = self._cache_dev.index_select(0, self._index(slots.clip(0)))
        miss = np.flatnonzero(~hit)
        if miss.size:
            miss_rows = self._to_device(self._gather(ids[miss]))
            out[self._index(miss)] = miss_rows
        if self.policy in ("fifo", "lru"):
            if miss.size:
                self._admit(ids[miss], miss_rows)
            if self.policy == "lru":
                # batch recency: one gather and one scatter on the stamps
                s = self._slot_table[ids]
                self._stamp[s[s >= 0]] = self._clock
                self._clock += 1
        return out

    def _admit(self, miss_ids: np.ndarray, miss_rows: torch.Tensor) -> None:
        """Admit missed rows as a batch: slots, eviction of the oldest
        stamps, one update of the device cache from the rows the fetch
        already moved (`miss_rows`, one per entry of `miss_ids`)."""
        ids, first = np.unique(np.asarray(miss_ids, np.int64),
                               return_index=True)
        keep = self._slot_table[ids] < 0
        ids, first = ids[keep], first[keep]
        if ids.size == 0:
            return
        if ids.size > self.capacity:
            # more misses than slots: sequential admission would keep the
            # batch's tail
            ids, first = ids[-self.capacity:], first[-self.capacity:]
        free = np.flatnonzero(self._resident < 0)
        if free.size < ids.size:
            n_evict = ids.size - free.size
            occ = np.flatnonzero(self._resident >= 0)
            if n_evict < occ.size:
                victims = occ[np.argpartition(self._stamp[occ],
                                              n_evict - 1)[:n_evict]]
            else:
                victims = occ
            self._slot_table[self._resident[victims]] = -1
            slots = np.concatenate([free, victims])[: ids.size]
        else:
            slots = free[: ids.size]
        self._slot_table[ids] = slots.astype(np.int32)
        self._resident[slots] = ids
        self._stamp[slots] = self._clock
        self._clock += 1
        self._cache_dev[self._index(slots)] = miss_rows[self._index(first)]


def make_feature_store(features, *, policy: str | None = "none",
                       cache_ratio: float = 0.05, out_degrees=None,
                       dtype: torch.dtype = torch.float32,
                       device: str | torch.device = "cuda") -> FeatureStore:
    """The store of `--cache-strategy`: "none" keeps every row on the
    device, any of POLICIES a host store with that cache policy."""
    if policy in ("none", None):
        return DeviceFeatureStore(features, dtype, device)
    return HostFeatureStore(features, policy=policy, cache_ratio=cache_ratio,
                            out_degrees=out_degrees, dtype=dtype,
                            device=device)
