"""Graph-partitioned aggregation over a mesh (counterpart of
`spgemm_gnn_tpu/parallel/`): the graph is partitioned by destination-node
blocks over D shards; each shard owns a contiguous node block and the
in-edges that end in it, and aggregates from its own rows and the rows the
exchange brings it (CBSR-compressed on the MaxK path: k values and k
channel ids a node instead of the hidden width).

In one process the D shards share one device (parallel/mesh.py::Mesh);
across processes each rank holds one shard (parallel/mesh.py::RankMesh,
started by parallel/multihost.py), and the exchange and the reductions are
collectives of torch.distributed.
"""

from spgemm_gnn_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from spgemm_gnn_tpu_torch.parallel.sharded import (  # noqa: F401
    ShardedGraph, shard_graph)
