"""Collectives of the landmark-sharded solve, over a process group.

The reference package shards the landmark axis of a window over a mesh
axis inside ``shard_map`` and names that axis in its solver (``psum`` of
the reduced system, ``all_gather`` of the trim scores). Here the axis is a
``torch.distributed`` process group (``parallel.sharding`` makes it from
the mesh's ``model`` dimension); ``None`` means an unsharded solve, and
every helper then returns its input unchanged.

Both helpers use ``all_reduce`` only: ``gloo`` takes CUDA tensors for it
(staged through the host) where it has no CUDA form of every other
collective, and NCCL takes it too, so one code path serves ranks that
share a card, ranks on cards of their own and ranks on the CPU. The
result of an ``all_reduce`` is the same on every rank, so every value a
rank derives from reduced values alone is the same on every rank.

Each call runs in a ``limo.all_reduce`` profiler range and adds its host
wall time (waiting for the other ranks and for the device included) to
``stats``.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

stats = {"calls": 0, "seconds": 0.0}


def all_reduce_sum(tensors, group):
    """Sum each tensor of ``tensors`` (one dtype) over the ranks of
    ``group``, packed into ONE ``all_reduce``; returns new tensors of the
    same shapes (the inputs are not modified)."""
    tensors = list(tensors)
    if group is None:
        return tensors
    with torch.profiler.record_function("limo.all_reduce"):
        t0 = time.perf_counter()
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat, group=group)
        stats["calls"] += 1
        stats["seconds"] += time.perf_counter() - t0
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def all_gather_cat(x, group, dim=0):
    """The ranks' shards of ``x`` concatenated along ``dim`` in group-rank
    order (every rank's shard has the same shape). Exact: each rank writes
    its shard at its offset into zeros and the buffers are summed, and a
    sum with zeros changes no value. Booleans and integers travel as
    int64."""
    if group is None:
        return x
    n, r = dist.get_world_size(group), dist.get_rank(group)
    wire = x.to(torch.int64) if not x.is_floating_point() else x
    shape = list(wire.shape)
    shape[dim] *= n
    buf = torch.zeros(shape, dtype=wire.dtype, device=wire.device)
    buf.narrow(dim, r * x.shape[dim], x.shape[dim]).copy_(wire)
    (buf,) = all_reduce_sum([buf], group)
    return buf.to(x.dtype)


def local_part(x, group, dim=0):
    """This rank's shard of a gathered ``x`` along ``dim``: the inverse of
    :func:`all_gather_cat`."""
    if group is None:
        return x
    size = x.shape[dim] // dist.get_world_size(group)
    return x.narrow(dim, dist.get_rank(group) * size, size)
