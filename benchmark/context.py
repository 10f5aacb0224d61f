"""What a per-layer metric's reader is given (`metrics/<name>.py::read`)."""
from __future__ import annotations

import collections
import dataclasses

from benchmark.trace import Trace


@dataclasses.dataclass
class Context:
    config: dict                  # the configuration's file
    traffic: dict                 # the traffic mix's file
    num_edges: int                # edges of the graph as run
    epoch_s: float                # the untraced window's seconds an epoch
    peak_window_bytes: int        # max_memory_allocated over that window
    trace: Trace | None           # the traced window (None: no trace)
    traced_epochs: int            # epochs inside the traced window
    launches: collections.Counter  # the port's launches in the traced window
    own_kernels: set[str]         # the port's kernel names

    @property
    def dtype(self) -> str:
        return self.traffic["dtype"]
