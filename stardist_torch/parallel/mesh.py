"""The process group of data-parallel training and multi-process prediction
(counterpart of ``stardist_tpu/parallel/mesh.py``).

The reference shards a batch over the devices of a JAX mesh, and only when
the device count divides the batch (``data_parallel_sharding``); XLA then
inserts the gradient all-reduce. Here the devices are the ranks of
``torch.distributed``'s default process group, one process per device, which
the caller initializes (as the reference's caller runs
``jax.distributed.initialize()``): NCCL between cards, gloo on the CPU and
for several ranks on one card (NCCL refuses two ranks on one device; gloo's
all-reduce and broadcast take CUDA tensors). Without a process group
everything here is the one-process case.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def world():
    """(rank, world size, process group) of the default process group, or
    (0, 1, None) when none is initialized."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    return 0, 1, None


def data_parallel_slice(batch_size):
    """This rank's rows of a batch of ``batch_size``: a slice, or None where
    the reference would not shard (one process, or a world size that does
    not divide the batch: every rank then runs the whole batch)."""
    rank, n, _ = world()
    if n <= 1 or batch_size % n != 0:
        return None
    k = batch_size // n
    return slice(rank * k, (rank + 1) * k)


def broadcast_numpy_rng(src=0):
    """Give every rank ``src``'s state of numpy's global RNG, so that each
    rank draws the same training stream (a no-op in one process)."""
    rank, n, group = world()
    if n <= 1:
        return
    state = [np.random.get_state() if rank == src else None]
    dist.broadcast_object_list(state, src=src, group=group)
    np.random.set_state(state[0])


def broadcast_parameters(module, src=0):
    """Give every rank ``src``'s parameters and buffers of ``module`` (a
    no-op in one process)."""
    rank, n, group = world()
    if n <= 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)
