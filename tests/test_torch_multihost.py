"""The multi-process runtime's plumbing (parallel/multihost.py) in one
process, against the JAX package's `parallel/multihost.py`: the
single-process no-op and the env vars, the hybrid mesh's shape rule and
its ValueError, the backend rule on both of its sides, `process_summary`,
and a process group of one rank. The ranks themselves are
tests/test_torch_multiprocess.py.

    python -m pytest tests/test_torch_multihost.py
"""
import pytest
import torch
import torch.distributed as dist

from spgemm_gnn_tpu.parallel import multihost as jmh
from spgemm_gnn_tpu_torch.parallel import multihost as tmh
from spgemm_gnn_tpu_torch.parallel.mesh import Mesh, RankMesh, make_mesh

ENV = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")


@pytest.fixture(autouse=True)
def clean_env(monkeypatch):
    for var in ENV + ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("args", [(None, 1, 0), (None, None, None),
                                  (None, 0, None)])
def test_single_process_is_a_no_op(args):
    """One process and no coordinator: nothing starts, in both packages."""
    assert jmh.initialize_multihost(*args) is False
    assert tmh.initialize_multihost(*args, device="cpu") is False
    assert not dist.is_initialized()


@pytest.mark.parametrize("env,match", [
    ({"NUM_PROCESSES": "1"}, None),
    ({"NUM_PROCESSES": "2"}, "--coordinator"),
    ({"COORDINATOR_ADDRESS": "h:1"}, "--num_processes"),
    ({"COORDINATOR_ADDRESS": "h:1", "NUM_PROCESSES": "2"}, "--process_id"),
    ({"COORDINATOR_ADDRESS": "h:1", "NUM_PROCESSES": "2",
      "PROCESS_ID": "2"}, "not a rank"),
])
def test_env_vars_read_as_jax_reads_them(monkeypatch, env, match):
    """The flags fall back to the JAX package's env vars; a world the
    runtime cannot start raises ValueError naming the missing flag (JAX
    leaves those to `jax.distributed`), before any connection."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    if match is None:
        assert jmh.initialize_multihost() is False
        assert tmh.initialize_multihost(device="cpu") is False
    else:
        with pytest.raises(ValueError, match=match):
            tmh.initialize_multihost(device="cpu")
    assert not dist.is_initialized()


@pytest.mark.parametrize("dcn,ici", [(2, 4), (None, 8), (4, None),
                                     (1, 8), (8, 1)])
def test_hybrid_shape_matches_jax(dcn, ici):
    """The (dp, graph) shape over 8 ranks is the JAX function's over its
    8 virtual devices, one factor inferred from the other."""
    want = jmh.make_hybrid_mesh(dcn=dcn, ici=ici).shape
    assert dict(zip(("dp", "graph"), tmh.hybrid_shape(dcn, ici, 8))) == want


@pytest.mark.parametrize("dcn,ici", [(3, 3), (3, None), (None, 3)])
def test_hybrid_shape_raises_off_the_world(dcn, ici):
    with pytest.raises(ValueError):
        jmh.make_hybrid_mesh(dcn=dcn, ici=ici)
    with pytest.raises(ValueError, match="ranks"):
        tmh.hybrid_shape(dcn, ici, 8)


def test_hybrid_shape_defaults_to_one_row_a_host():
    assert tmh.hybrid_shape(None, None, 8, hosts=1) == (1, 8)
    assert tmh.hybrid_shape(None, None, 8, hosts=2) == (2, 4)


def test_hybrid_mesh_of_one_process():
    """Without a process group the hybrid mesh is one rank: shape 1 x 1,
    no group, and every collective the identity."""
    mesh = tmh.make_hybrid_mesh(device="cpu")
    assert isinstance(mesh, RankMesh)
    assert mesh.shape == {"dp": 1, "graph": 1}
    assert (mesh.num_shards, mesh.shard, mesh.group, mesh.ranks) == (
        1, 0, None, (0,))
    t = torch.arange(6.0).view(3, 2)
    assert torch.equal(mesh.all_reduce(t), t)
    assert torch.equal(mesh.all_gather(t), t)
    assert mesh.backend is None and not mesh.staged
    with pytest.raises(ValueError, match="2x1 != 1 ranks"):
        tmh.make_hybrid_mesh(dcn=2, ici=1, device="cpu")


@pytest.mark.parametrize("device,local,gpus,want", [
    ("cuda", 2, 2, "nccl"), ("cuda", 4, 8, "nccl"), ("cuda", 1, 1, "nccl"),
    ("cuda", 2, 1, "gloo"), ("cpu", 1, 0, "gloo"), ("cpu", 2, 8, "gloo")])
def test_backend_rule(device, local, gpus, want):
    """nccl where every rank on the host has a GPU of its own, else gloo
    (the CPU; ranks sharing a GPU)."""
    assert tmh.backend_for(device, local, gpus) == want


def test_local_placement_reads_its_env(monkeypatch):
    assert tmh.local_placement(5, 8) == (5, 8)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    assert tmh.local_placement(5, 8) == (1, 4)


def test_process_summary_has_jax_keys():
    """The JAX function's keys and, on one process, its index and count;
    one device a rank (JAX's test sees 8 virtual devices); then the
    backend (none started) and the rank's device."""
    j, t = jmh.process_summary(), tmh.process_summary("cpu")
    assert set(j) <= set(t)
    assert (t["process_index"], t["process_count"]) == (
        j["process_index"], j["process_count"]) == (0, 1)
    assert (t["local_devices"], t["global_devices"]) == (1, 1)
    assert (t["backend"], t["device"]) == (None, "cpu")


def test_make_mesh_in_one_process():
    assert make_mesh(4, "cpu") == Mesh(4, torch.device("cpu"))
    assert tmh.rank_device("cpu") == torch.device("cpu")


def test_a_group_of_one_rank(tmp_path):
    """A coordinator with a world of one starts a gloo group (JAX's rule:
    a coordinator initialises); a second call with the same world is a
    no-op, another rank raises; a mesh is then still in-process."""
    coord = f"file://{tmp_path}/rdzv"
    try:
        assert tmh.initialize_multihost(coord, 1, 0, "cpu") is True
        assert tmh.initialize_multihost(coord, 1, 0, "cpu") is True
        s = tmh.process_summary("cpu")
        assert (s["backend"], s["process_count"]) == ("gloo", 1)
        assert isinstance(make_mesh(2, "cpu"), Mesh)
        mesh = tmh.make_hybrid_mesh(device="cpu")
        assert mesh.shape == {"dp": 1, "graph": 1} and mesh.group is None
        with pytest.raises(RuntimeError, match="already running"):
            tmh.initialize_multihost(coord, 2, 1, "cpu")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert not dist.is_initialized()
