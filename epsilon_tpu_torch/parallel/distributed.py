"""Multi-process runtime glue.

Counterpart of ``epsilon_tpu/parallel/distributed.py``: every process calls
:func:`initialize_distributed`, after which :func:`~.consensus.block_mesh`
returns the world group and the consensus solver's reductions run as
``torch.distributed`` collectives: NCCL between CUDA devices, gloo on the
CPU.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist

from .. import config

__all__ = ["initialize_distributed"]


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """``torch.distributed.init_process_group`` from the arguments or torch's
    standard variables (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``).  ``coordinator_address`` is an init method URL
    (``tcp://host:port`` or ``file:///path``); ``host:port`` means TCP.
    No-op when neither names a coordinator (a single process).

    The backend is NCCL when the port's device is CUDA (each process takes
    the card ``LOCAL_RANK``, else its rank modulo the card count) and gloo
    on the CPU."""
    if coordinator_address is None:
        if "MASTER_ADDR" not in os.environ:
            return
        init_method = "env://"
    else:
        init_method = (coordinator_address if "://" in coordinator_address
                       else f"tcp://{coordinator_address}")
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if config.on_cuda():
        backend = "nccl"
        torch.cuda.set_device(int(os.environ.get(
            "LOCAL_RANK", process_id % torch.cuda.device_count())))
    else:
        backend = "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)
