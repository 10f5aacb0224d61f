"""Dataset loading (counterpart of `spgemm_gnn_tpu/graphs/datasets.py`).

Datasets are read from the repository's `.npz` interchange format (one file
per dataset under `data_path`, written by `scripts/convert_to_npz.py`). When
the file is absent, `load_dataset` can build a synthetic stand-in with the
dataset's node count, edge count, feature width and class count; its numpy
arrays are identical to the JAX package's for the same seed.

npz schema:
  edge_src, edge_dst : int64[E]   directed edge list
  feat               : float32[N, F]   node features (absent for proteins)
  label              : int64[N] or float32[N, C] (multilabel)
  train_mask, val_mask, test_mask : bool[N]
  num_classes        : int scalar
  edge_feat          : float32[E, 8]  (ogbn-proteins only)
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from spgemm_gnn_tpu_torch.graphs.csr import Graph, add_self_loops, from_edges
from spgemm_gnn_tpu_torch.graphs.synthetic import powerlaw_graph

DATASETS = ("reddit", "flickr", "yelp", "ogbn-arxiv", "ogbn-products",
            "ogbn-proteins")

# multilabel datasets train with BCE-with-logits and report micro-F1
MULTILABEL = ("yelp", "ogbn-proteins")

# N / E / feature width / classes of the synthetic stand-ins
SYNTH_SPECS = {
    "reddit":        dict(n=232_965, e=114_615_892, f=602, c=41),
    "flickr":        dict(n=89_250, e=899_756, f=500, c=7),
    "yelp":          dict(n=716_847, e=13_954_819, f=300, c=100),
    "ogbn-arxiv":    dict(n=169_343, e=1_166_243, f=128, c=40),
    "ogbn-products": dict(n=2_449_029, e=123_718_280, f=100, c=47),
    "ogbn-proteins": dict(n=132_534, e=79_122_504, f=8, c=112),
}


@dataclasses.dataclass
class Dataset:
    name: str
    graph: Graph
    features: np.ndarray          # float32 [N, F]
    labels: np.ndarray            # int64 [N] or float32 [N, C]
    train_mask: np.ndarray        # bool [N]
    val_mask: np.ndarray
    test_mask: np.ndarray
    num_classes: int
    multilabel: bool

    @property
    def num_nodes(self) -> int:
        return self.graph.num_nodes


def _npz_path(data_path: str, name: str) -> str:
    return os.path.join(data_path, f"{name.replace('-', '_')}.npz")


def load_dataset(name: str, data_path: str = "./data", *,
                 self_loop: bool = False, allow_synthetic: bool = False,
                 synthetic_scale: float = 1.0, seed: int = 0,
                 synthetic_payload: bool = True) -> Dataset:
    """Load a dataset from npz, or its synthetic stand-in when allowed.

    self_loop applies the remove-then-add self-loop transform.
    synthetic_payload=False gives the stand-in zero placeholders for its
    features and labels (`_synthetic_dataset(payload=False)`), for runs
    that draw them on the device (`device_synthetic_inputs`).
    """
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; expected one of {DATASETS}")
    path = _npz_path(data_path, name)
    if os.path.exists(path):
        ds = _load_npz(name, path)
    elif allow_synthetic:
        ds = _synthetic_dataset(name, scale=synthetic_scale, seed=seed,
                                payload=synthetic_payload)
    else:
        raise FileNotFoundError(
            f"{path} not found. Produce it with scripts/convert_to_npz.py on a "
            f"machine with DGL/OGB, or use a synthetic structural stand-in "
            f"(CLI: --synthetic; API: allow_synthetic=True).")
    if self_loop:
        ds.graph = add_self_loops(ds.graph)
    return ds


def _load_npz(name: str, path: str) -> Dataset:
    z = np.load(path)
    n = z["train_mask"].shape[0]
    graph = from_edges(z["edge_src"], z["edge_dst"], n)
    if name == "ogbn-proteins":
        # node features = sum of the incident 8-dim edge features (in-edges)
        feat = np.zeros((n, z["edge_feat"].shape[1]), dtype=np.float32)
        np.add.at(feat, z["edge_dst"], z["edge_feat"].astype(np.float32))
        labels = z["label"].astype(np.float32)
    else:
        feat = z["feat"].astype(np.float32)
        labels = z["label"]
        if name in MULTILABEL:
            labels = labels.astype(np.float32)
        else:
            labels = labels.astype(np.int64).ravel()
    return Dataset(
        name=name, graph=graph, features=feat, labels=labels,
        train_mask=z["train_mask"].astype(bool),
        val_mask=z["val_mask"].astype(bool),
        test_mask=z["test_mask"].astype(bool),
        num_classes=int(z["num_classes"]),
        multilabel=name in MULTILABEL,
    )


def _split(rng: np.random.Generator, n: int
           ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The stand-ins' 60/20/20 train/val/test masks from one permutation."""
    idx = rng.permutation(n)
    masks = tuple(np.zeros(n, bool) for _ in range(3))
    masks[0][idx[: int(0.6 * n)]] = True
    masks[1][idx[int(0.6 * n): int(0.8 * n)]] = True
    masks[2][idx[int(0.8 * n):]] = True
    return masks


def _synthetic_dataset(name: str, scale: float = 1.0, seed: int = 0,
                       payload: bool = True) -> Dataset:
    """Structural stand-in: a power-law graph of the dataset's N and E,
    random features, and labels with a planted signal so that training curves
    are not flat. Identical arrays to the JAX package's stand-in.

    payload=False: zero features and labels of the right shapes and dtypes
    (no host cost), the graph and masks built as usual (the masks then come
    from the generator's first draw, as in the JAX package)."""
    spec = SYNTH_SPECS[name]
    n = max(int(spec["n"] * scale), 128)
    e = max(int(spec["e"] * scale), 512)
    f, c = spec["f"], spec["c"]
    graph = powerlaw_graph(n, e // 2, seed=seed)
    rng = np.random.default_rng(seed + 1)
    multilabel = name in MULTILABEL
    if not payload:
        labels = (np.zeros((n, c), np.float32) if multilabel
                  else np.zeros(n, np.int64))
        train_mask, val_mask, test_mask = _split(rng, n)
        return Dataset(name=name, graph=graph,
                       features=np.zeros((n, f), np.float32), labels=labels,
                       train_mask=train_mask, val_mask=val_mask,
                       test_mask=test_mask, num_classes=c,
                       multilabel=multilabel)
    feat = rng.standard_normal((n, f), dtype=np.float32)
    if multilabel:
        # per-class unit directions in an r-dim subspace; labels threshold
        # each projection, then labelled rows are pushed to a ±2.5 margin
        r = min(64, f)
        w = rng.standard_normal((r, c)).astype(np.float32)
        w /= np.linalg.norm(w, axis=0, keepdims=True)
        z = feat[:, :r] @ w
        q = 0.5 if r >= 32 else 0.65
        thr = np.quantile(z, q, axis=0)
        labels = (z > thr).astype(np.float32)
        if r >= 32:
            margin = 2.5
            for _ in range(3):
                gap = feat[:, :r] @ w - thr
                push = np.where(labels > 0,
                                np.maximum(margin - gap, 0.0),
                                -np.maximum(margin + gap, 0.0))
                feat[:, :r] += (push @ w.T).astype(np.float32)
    else:
        # class centroids in a 16-dim feature subspace
        r = min(16, f)
        labels = rng.integers(0, c, n).astype(np.int64)
        mu = rng.standard_normal((c, r)).astype(np.float32) * 2.5
        feat[:, :r] += mu[labels]
    train_mask, val_mask, test_mask = _split(rng, n)
    return Dataset(name=name, graph=graph, features=feat, labels=labels,
                   train_mask=train_mask, val_mask=val_mask,
                   test_mask=test_mask, num_classes=c, multilabel=multilabel)


def _quantile(z: torch.Tensor, q: float) -> torch.Tensor:
    """np.quantile(z, q, axis=0) (linear interpolation) through a sort, on
    z's device: `torch.quantile` refuses inputs of more than 2^24 values."""
    s = torch.sort(z, dim=0).values
    pos = q * (z.shape[0] - 1)
    lo = int(np.floor(pos))
    hi = min(lo + 1, z.shape[0] - 1)
    return s[lo] + (s[hi] - s[lo]) * (pos - lo)


def device_synthetic_inputs(name: str, scale: float = 1.0, seed: int = 0,
                            device: str | torch.device = "cuda"
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """The stand-in's features f32 [N, F] and labels, drawn on `device`
    (counterpart of `spgemm_gnn_tpu/graphs/datasets.py::
    device_synthetic_inputs`): `_synthetic_dataset`'s distributions,
    planted signal, quantile threshold and margin pushes, from a
    `torch.Generator` on the device seeded `seed + 1`, so that no feature
    crosses from the host. Statistically equivalent to the host stand-in,
    not bit-equal, as in the JAX package. Labels are f32 [N, C] for the
    multilabel datasets, else int64 [N] (torch's class-index type; JAX
    draws int32)."""
    spec = SYNTH_SPECS[name]
    n = max(int(spec["n"] * scale), 128)
    f, c = spec["f"], spec["c"]
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    feat = torch.randn((n, f), generator=gen, device=device)
    if name in MULTILABEL:
        r = min(64, f)
        w = torch.randn((r, c), generator=gen, device=device)
        w = w / torch.linalg.vector_norm(w, dim=0, keepdim=True)
        z = feat[:, :r] @ w
        q = 0.5 if r >= 32 else 0.65
        thr = _quantile(z, q)
        labels = (z > thr).float()
        if r >= 32:
            margin = 2.5
            for _ in range(3):
                gap = feat[:, :r] @ w - thr
                push = torch.where(labels > 0,
                                   torch.clamp(margin - gap, min=0.0),
                                   -torch.clamp(margin + gap, min=0.0))
                feat[:, :r] += push @ w.T
        return feat, labels
    r = min(16, f)
    labels = torch.randint(0, c, (n,), generator=gen, device=device)
    mu = torch.randn((c, r), generator=gen, device=device) * 2.5
    feat[:, :r] += mu[labels]
    return feat, labels
