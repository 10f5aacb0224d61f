"""The multi-process runtime (counterpart of
`spgemm_gnn_tpu/parallel/multihost.py`): `torch.distributed` in place of
`jax.distributed`, one graph shard a rank.

- `initialize_multihost()` starts the process group from the flags, or the
  env vars `COORDINATOR_ADDRESS` / `NUM_PROCESSES` / `PROCESS_ID` (the JAX
  function's), at `tcp://<coordinator>` (an address with a scheme, such as
  `file:///tmp/rdzv`, is taken as it is). A single process (num_processes
  in {None, 0, 1} and no coordinator) is a no-op, so the same CLI runs one
  process or many.
- `backend_for()` is the backend rule, stated and logged, never a fallback
  (nothing catches an NCCL error to retry on gloo): "nccl" where the rank's
  device is CUDA and the host has a GPU for each of its ranks; "gloo"
  otherwise, on the CPU or where ranks share a GPU (a one-GPU machine runs
  every rank on `cuda:0`, and the exchange is staged through pinned host
  memory: parallel/mesh.py::RankMesh).
- A rank's device is `cuda:(local_rank % device_count)` (`rank_device`).
  `LOCAL_RANK` / `LOCAL_WORLD_SIZE` say where a rank sits on its host;
  without them every rank is on one host.
- `make_hybrid_mesh(dcn, ici)` lays the world out as a (dcn, ici) = ("dp",
  "graph") grid with DCN outermost, as the JAX function: a process group
  for each "graph" row (the halo exchange stays inside it) and one for each
  "dp" column (gradient reduction). `hybrid_shape` is its arithmetic.
- `process_summary()` gives the JAX function's keys, and the backend and
  the rank's device.
"""
from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from spgemm_gnn_tpu_torch.parallel.mesh import RankMesh, world
from spgemm_gnn_tpu_torch.utils.device import resolve_device

_log = logging.getLogger(__name__)


def _env_int(name: str) -> int | None:
    value = os.environ.get(name)
    return None if value in (None, "") else int(value)


def local_placement(rank: int, world_size: int) -> tuple[int, int]:
    """(local rank, ranks on this host): `LOCAL_RANK` and
    `LOCAL_WORLD_SIZE` where set, else every rank on one host."""
    local = _env_int("LOCAL_RANK")
    local_world = _env_int("LOCAL_WORLD_SIZE")
    return (rank if local is None else local,
            world_size if local_world is None else local_world)


def backend_for(device_type: str, local_world_size: int,
                gpu_count: int) -> str:
    """The backend rule: "nccl" where the ranks' device is CUDA and the
    host has at least one GPU for each of its `local_world_size` ranks,
    else "gloo" (the CPU, or ranks sharing a GPU)."""
    if device_type == "cuda" and gpu_count >= local_world_size:
        return "nccl"
    return "gloo"


def rank_device(device: str | torch.device | None = None,
                local_rank: int | None = None) -> torch.device:
    """The device of this rank: the CPU where `device` asks for it, else
    `cuda:(local_rank % device_count)` (local_rank: this process's, by
    default)."""
    dev = resolve_device(device)
    if dev.type != "cuda":
        return dev
    if local_rank is None:
        local_rank = local_placement(*world())[0]
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         device: str | torch.device | None = None) -> bool:
    """Start the process group; True if it runs (module docstring). A
    coordinator without a world size or a rank raises ValueError naming
    the flag, as does a world of more than one process without a
    coordinator. `device` is the ranks' device type (the card unless the
    caller asks for the CPU). Called again with the same world and rank,
    it returns True and starts nothing."""
    coordinator = coordinator_address or os.environ.get("COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("PROCESS_ID")
    if num_processes in (None, 0, 1) and coordinator is None:
        return False
    if coordinator is None:
        raise ValueError(f"--num_processes {num_processes} needs "
                         f"--coordinator HOST:PORT (or COORDINATOR_ADDRESS)")
    if num_processes is None:
        raise ValueError("--coordinator needs --num_processes (or "
                         "NUM_PROCESSES)")
    if process_id is None:
        raise ValueError("--coordinator needs --process_id (or PROCESS_ID)")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"--process_id {process_id} is not a rank of "
                         f"--num_processes {num_processes}")
    if dist.is_initialized():
        if world() != (process_id, num_processes):
            raise RuntimeError(f"a process group of rank {world()[0]} in "
                               f"{world()[1]} is already running")
        return True
    local_rank, local_world = local_placement(process_id, num_processes)
    dev = rank_device(device, local_rank)
    gpus = torch.cuda.device_count() if dev.type == "cuda" else 0
    backend = backend_for(dev.type, local_world, gpus)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    init = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(backend, init_method=init,
                            world_size=num_processes, rank=process_id)
    _log.info("rank %d of %d on %s, backend %s (%d local ranks, %d GPUs%s)",
              process_id, num_processes, dev, backend, local_world, gpus,
              "; ranks share a GPU: the exchange is staged through pinned "
              "host memory" if backend == "gloo" and gpus else "")
    return True


def hybrid_shape(dcn: int | None, ici: int | None, world_size: int,
                 hosts: int = 1) -> tuple[int, int]:
    """(dcn, ici) of a hybrid mesh over `world_size` ranks, the JAX
    function's inference: both None gives one "dp" row a host; one None is
    inferred from the other; a product other than the world raises
    ValueError."""
    if dcn is None and ici is None:
        dcn = hosts
    if dcn is None:
        dcn = world_size // ici
    if ici is None:
        ici = world_size // dcn
    if dcn * ici != world_size:
        raise ValueError(f"mesh {dcn}x{ici} != {world_size} ranks")
    return dcn, ici


def make_hybrid_mesh(dcn: int | None = None, ici: int | None = None,
                     dcn_axis: str = "dp", ici_axis: str = "graph",
                     device: str | torch.device | None = None) -> RankMesh:
    """The world's ranks as a (dcn, ici) grid with DCN outermost: rank
    i·ici + j is shard j of "graph" row i and member i of "dp" column j.
    Every rank makes every group (torch.distributed's rule), in one order.
    Without a process group, the one-rank mesh."""
    rank, size = world()
    hosts = max(size // local_placement(rank, size)[1], 1)
    dcn, ici = hybrid_shape(dcn, ici, size, hosts)
    rows = [tuple(i * ici + j for j in range(ici)) for i in range(dcn)]
    cols = [tuple(i * ici + j for i in range(dcn)) for j in range(ici)]
    groups = {}
    if size > 1:
        for ranks in rows + cols:
            if len(ranks) == size:
                groups[ranks] = dist.group.WORLD
            elif len(ranks) > 1:
                groups[ranks] = dist.new_group(list(ranks))
    row, col = rows[rank // ici], cols[rank % ici]
    return RankMesh(num_shards=ici, shard=rank % ici,
                    device=rank_device(device), ranks=row,
                    group=groups.get(row), dp=dcn, dp_ranks=col,
                    dp_group=groups.get(col), axis=ici_axis,
                    dp_axis=dcn_axis)


def process_summary(device: str | torch.device | None = None) -> dict:
    """The JAX function's keys (one device a rank: `local_devices` 1,
    `global_devices` the world size), the backend (None without a process
    group) and the rank's device."""
    rank, size = world()
    return {"process_index": rank, "process_count": size,
            "local_devices": 1, "global_devices": size,
            "backend": (dist.get_backend() if dist.is_available()
                        and dist.is_initialized() else None),
            "device": str(rank_device(device))}
