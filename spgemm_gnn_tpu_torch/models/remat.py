"""Rematerialisation of a layer (`--remat`; counterpart of the JAX
package's `nn.remat` / `jax.checkpoint` with the policy "save only the
aggregation outputs", `spgemm_gnn_tpu/models/models.py:19-25,56-97`).

`remat(body, x, generator=...)` runs a layer's body under
`torch.utils.checkpoint.checkpoint(use_reentrant=False)`: its forward keeps
only the layer's input and the outputs of its aggregations, and the
backward reruns the rest (MaxK, dropout, the dense layers, the norms) to
rebuild what they saved. The aggregation is linear, so its backward needs
no forward rerun: each `Aggregate` of the body records its output (a
`Tape` through `saved_output`) in the forward and hands the recorded
tensor back in the rerun instead of launching its kernel again. (Under
impl "torch" the plain product, the tests' oracle, is not an `Aggregate`
and reruns.)

Bit-equality with the run without remat rests on three things:
- the rerun draws the forward's dropout noise: the port's dropout takes an
  explicit generator, which `checkpoint`'s `preserve_rng_state` does not
  cover, so the generator's state is taken before the forward and set back
  for the rerun, then restored to where the backward found it;
- every kernel of the body is deterministic, so MaxK's kept channels (the
  sampled backward's ids) come out of the rerun unchanged;
- a BatchNorm's running statistics move once, in the forward
  (`recomputing()` tells it it is in the rerun).
"""
from __future__ import annotations

import contextlib
import threading
from typing import Callable

import torch
from torch.utils.checkpoint import checkpoint

_local = threading.local()


class Tape:
    """The aggregation outputs of one checkpointed call, in call order, and
    the state of its dropout generator before its forward."""

    def __init__(self, generator: torch.Generator | None):
        self.outputs: list[torch.Tensor] = []
        self.replay_at: int | None = None   # None outside a rerun
        self.generator = generator
        self.rng_state = (generator.get_state() if generator is not None
                          else None)


def _tape() -> Tape | None:
    return getattr(_local, "tape", None)


@contextlib.contextmanager
def _recording(tape: Tape):
    prev, _local.tape = _tape(), tape
    try:
        yield
    finally:
        _local.tape = prev


@contextlib.contextmanager
def _replaying(tape: Tape):
    prev, _local.tape = _tape(), tape
    tape.replay_at = 0
    gen = tape.generator
    now = None
    if gen is not None:
        now = gen.get_state()
        gen.set_state(tape.rng_state)
    try:
        yield
    finally:
        if gen is not None:
            gen.set_state(now)
        tape.replay_at = None
        _local.tape = prev


def recomputing() -> bool:
    """True inside the backward's rerun of a checkpointed layer."""
    tape = _tape()
    return tape is not None and tape.replay_at is not None


def saved_output(compute: Callable[[], torch.Tensor]) -> torch.Tensor:
    """`compute()`, an aggregation's output: outside a checkpointed layer
    as it is; in one's forward also recorded on its tape (a detached alias,
    so the tape holds no autograd graph); in its rerun the recorded tensor,
    with no kernel launched."""
    tape = _tape()
    if tape is None:
        return compute()
    if tape.replay_at is None:
        y = compute()
        tape.outputs.append(y.detach())
        return y
    y = tape.outputs[tape.replay_at]
    tape.replay_at += 1
    return y.detach()


def remat(body: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
          generator: torch.Generator | None = None) -> torch.Tensor:
    """body(x) with its activations recomputed in the backward, its
    aggregation outputs kept (module docstring). `generator` is the
    dropout generator the body draws from. Without grad mode (evaluation)
    body(x) runs as it is."""
    if not torch.is_grad_enabled():
        return body(x)
    tape = Tape(generator)
    return checkpoint(body, x, use_reentrant=False,
                      preserve_rng_state=generator is None,
                      context_fn=lambda: (_recording(tape),
                                          _replaying(tape)))
