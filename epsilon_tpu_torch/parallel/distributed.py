"""Multi-process runtime glue.

Counterpart of ``epsilon_tpu/parallel/distributed.py``: every process calls
:func:`initialize_distributed`, after which :func:`~.consensus.block_mesh`
returns the world group, and the reductions of the consensus solver and of
the meshed two-block solver (``SolverParams.mesh``) run as
``torch.distributed`` collectives over it.

The backend follows from the machine (:func:`choose_backend`): gloo on the
CPU; NCCL when the machine has a card for every process it runs, each
process on its own; otherwise gloo with CUDA tensors, every process on card
0 (NCCL refuses two ranks on one device; gloo all-reduces CUDA tensors
through the host).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import config

__all__ = ["initialize_distributed", "choose_backend"]


def choose_backend(num_processes: int, process_id: int):
    """``(backend, card)`` for process ``process_id`` of ``num_processes``:
    ``("gloo", None)`` when the port's device is the CPU; ``("nccl", card)``
    when this machine has a card for each of ITS processes
    (``torch.cuda.device_count()`` against ``LOCAL_WORLD_SIZE``, or against
    ``num_processes`` where a launcher set none: one machine), the card
    ``LOCAL_RANK`` or else the rank modulo the machine's cards; otherwise
    ``("gloo", 0)``: CUDA tensors on card 0, reduced through the host.  A
    rule of the machine, not a fallback: nothing is tried and caught."""
    if not config.on_cuda():
        return "gloo", None
    cards = torch.cuda.device_count()
    if cards >= int(os.environ.get("LOCAL_WORLD_SIZE", num_processes)):
        return "nccl", int(os.environ.get("LOCAL_RANK", process_id % cards))
    return "gloo", 0


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> Optional[str]:
    """``torch.distributed.init_process_group`` from the arguments or torch's
    standard variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  ``coordinator_address`` is an init method URL
    (``tcp://host:port`` or ``file:///path``); ``host:port`` means TCP.
    No-op (returns None) when neither names a coordinator (a single
    process).

    The backend and the process's card come from :func:`choose_backend`;
    the backend's name is returned and printed.  A failing
    ``init_process_group`` raises."""
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ:
            return None
        init_method = "env://"
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    backend, card = choose_backend(num_processes, process_id)
    if card is not None:
        # the port's device stays "cuda": the process's current card
        torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
    print(f"epsilon_tpu_torch: rank {process_id} of {num_processes}, "
          f"backend {backend}"
          + ("" if card is None else f", card {card}"), flush=True)
    return backend
