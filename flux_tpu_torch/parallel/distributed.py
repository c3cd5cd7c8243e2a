"""Joining a process group (``flux_tpu/parallel/distributed.py``).

``flux_tpu`` joins hosts of a TPU slice with ``jax.distributed.initialize``;
here the processes join a ``torch.distributed`` process group, after which
:func:`~flux_tpu_torch.parallel.make_mesh` spans every process's devices
and :class:`~flux_tpu_torch.parallel.MeshRenderer` renders each process's
slots and exchanges the partial sums. Processes that do not share a group
still cooperate through the render node (:mod:`flux_tpu_torch.node`).
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["init_multihost"]


def init_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join this process to a ``torch.distributed`` process group; raises
    when it cannot.

    With ``coordinator_address`` (``host:port`` of rank 0),
    ``num_processes`` and ``process_id``, the group meets over TCP there.
    With none of them it reads ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``
    and ``WORLD_SIZE`` from the environment (``env://``, as ``torchrun``
    sets them). ``backend`` defaults to ``nccl`` where CUDA is available and
    ``gloo`` otherwise; name ``gloo`` where two processes share a card,
    which NCCL refuses."""
    import torch.distributed as dist

    if not dist.is_available():
        raise RuntimeError("this PyTorch has no torch.distributed")
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    given = (coordinator_address, num_processes, process_id)
    if all(v is None for v in given):
        dist.init_process_group(backend=backend, init_method="env://")
        return
    if any(v is None for v in given):
        raise ValueError("give coordinator_address, num_processes and process_id together, or none of them")
    dist.init_process_group(
        backend=backend,
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
    )
