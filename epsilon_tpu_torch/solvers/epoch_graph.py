"""An ADMM epoch replayed as a CUDA graph.

A loop of small operators is paced by the host: each of an epoch's few
hundred launches costs tens of microseconds of Python while the card
waits.  Between its host syncs (one an epoch, the residual check) an epoch
of the two-block solver has fixed shapes and a fixed launch sequence, so
where every operator it applies is capturable
(:meth:`~epsilon_tpu_torch.ops.prox.operator.ProxOperator.capturable`) the
loop captures the epoch once and replays it, with the same kernels on the
same arguments.

- The loop state lives in buffers that :class:`EpochGraph` owns, outside
  the graph's memory pool; the captured epoch ends by copying its new state
  into them, and its primal output and residuals are the graph's outputs.
- A solver's first epoch runs eagerly: the operators upload their data at
  their first apply, which a capture must not do, and every kernel and
  library handle the epoch uses is loaded.  The next epoch captures.
- A new key (an operator rebuilt by ``update_problem``, another parameter)
  captures at once: each operator the last epoch did not apply is applied
  once eagerly first (``prime``), which uploads its data.
- A new key captures a new graph into the pool of the one it replaces,
  which is then dropped, so device memory does not grow over a path.
- Every epoch of a graphed loop runs on one side stream (a capture cannot
  run on the default stream, and cuBLAS keeps its workspace by stream), and
  the caller's stream waits for it at the end.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..ops.block import BlockVector
from ..utils.timing import count

# One side stream a device for every solver: cuBLAS allocates a workspace
# for each stream it runs on, which a stream of each solver's own would
# multiply.
_SIDE: Dict[torch.device, "torch.cuda.Stream"] = {}


def _side_stream(device: torch.device):
    stream = _SIDE.get(device)
    if stream is None:
        stream = _SIDE[device] = torch.cuda.Stream(device)
    return stream


def _like(state):
    """Empty buffers of the loop state's layout (a tuple of block vectors,
    0-d tensors and Nones)."""
    if isinstance(state, BlockVector):
        return BlockVector({k: torch.empty_like(v) for k, v in state.items()})
    if isinstance(state, torch.Tensor):
        return torch.empty_like(state)
    if isinstance(state, tuple):
        return tuple(_like(s) for s in state)
    return state


def _copy_into(dst, src):
    if isinstance(dst, BlockVector):
        for k, v in dst.items():
            if src[k] is not v:
                v.copy_(src[k])
    elif isinstance(dst, torch.Tensor):
        if src is not dst:
            dst.copy_(src)
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)


class EpochGraph:
    """The captured epoch of one solver and its static loop state.

    ``key`` is ``(operators, parameters)``: the operators the epoch applies
    (compared by identity, and held, so that no identity is reused) and the
    parameters it reads; ``prime(ops)`` applies each of ``ops`` once,
    eagerly.  Use::

        with graph.epochs(epoch, prime, key, device) as run:
            state, x, res = run(state)     # once an epoch

    ``state`` comes back as the static buffers; ``x`` and ``res`` are the
    graph's outputs after a replay, which the next replay overwrites."""

    def __init__(self):
        self.state = None      # the static loop state
        self.graph = None
        self.key = self.out = None
        self.warm = None       # the operators of the last epoch that ran

    def epochs(self, epoch, prime, key, device):
        return _Epochs(self, epoch, prime, key, device)

    def _capture(self, epoch, key):
        graph = torch.cuda.CUDAGraph()
        # share the pool of the graph this one replaces, which is still alive
        pool = () if self.graph is None else (self.graph.pool(),)
        graph.capture_begin(*pool)
        try:
            new, x, res = epoch(self.state)
            _copy_into(self.state, new)
        finally:
            graph.capture_end()
        self.graph, self.key, self.out = graph, key, (x, res)
        count("admm.graph_captures")


class _Epochs:
    def __init__(self, owner: EpochGraph, epoch, prime, key, device):
        self.owner, self.epoch, self.prime, self.key = owner, epoch, prime, key
        self.side = _side_stream(device)

    def __enter__(self):
        self.caller = torch.cuda.current_stream(self.side.device)
        self.side.wait_stream(self.caller)
        self.ctx = torch.cuda.stream(self.side)
        self.ctx.__enter__()
        return self

    def __exit__(self, *exc):
        self.ctx.__exit__(*exc)
        self.caller.wait_stream(self.side)
        return False

    def __call__(self, state):
        g = self.owner
        if g.state is None:
            with torch.cuda.stream(self.caller):   # outside the side stream's pool
                g.state = _like(state)
        if state is not g.state:
            _copy_into(g.state, state)
        ops = self.key[0]
        if g.key != self.key:
            if g.warm is None:
                new, x, res = self.epoch(g.state)
                _copy_into(g.state, new)
                g.warm = ops
                return g.state, x, res
            self.prime([op for op in ops if op is not None
                        and all(op is not old for old in g.warm)])
            g._capture(self.epoch, self.key)
            g.warm = ops
        g.graph.replay()
        count("admm.graph_epochs")
        return (g.state,) + g.out
