"""Multi-process execution helpers — the counterpart of the reference
package's ``limo_tpu/parallel/multihost.py``.

The reference runs one JAX process per host over all of its devices; here
a rank is one process with one device (a card, or the CPU), started by a
launcher (``torchrun``, or :func:`spawn` below) and joined by
``torch.distributed``. The layout follows the reference's recipe:

- the **model** (landmark-shard) axis stays inside one host: the solver's
  per-LM-iteration ``all_reduce`` of the reduced pose system rides it;
- the **data** (window or sequence batch) axis spans hosts: sequences are
  independent, so no collective of the solver crosses it.

One process and no launcher is a no-op: :func:`initialize` returns False,
the meshes are one rank's (:class:`OneRankMesh`, whose groups are
``None``, which the solver reads as unsharded), and
:func:`host_local_to_global` is a put on the device.

The backend is always the caller's choice: ``nccl`` for one rank per card,
``gloo`` where ranks share a card or run on the CPU. NCCL refuses two
ranks on one card, so :func:`initialize` raises before it is asked to.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.collectives import all_gather_cat

DATA_AXIS = "data"
MODEL_AXIS = "model"


def initialize(backend: str, coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               timeout_s: float = 300.0) -> bool:
    """Join the process group of a multi-process run; a no-op that returns
    False when no coordinator is given and the launcher's environment
    (``MASTER_ADDR``, ``RANK``, ``WORLD_SIZE``) is absent.

    ``coordinator_address`` is an ``init_method`` URL (``tcp://host:port``
    or ``file:///path``) with ``num_processes`` and ``process_id``.
    Every collective fails after ``timeout_s`` seconds, so ranks that part
    ways end in an error, not a hang. Only a second initialisation with
    the same backend is tolerated."""
    if dist.is_initialized():
        if dist.get_backend() != backend:
            raise RuntimeError(f"process group already initialised with "
                               f"{dist.get_backend()}, not {backend}")
        return dist.get_world_size() > 1
    if coordinator_address is None and num_processes is None:
        if not all(k in os.environ
                   for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE")):
            return False
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        init_method = coordinator_address
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
        cards = torch.cuda.device_count()
        if local > cards:
            raise RuntimeError(
                f"nccl takes one rank per card: {local} ranks on this host, "
                f"{cards} cards (ranks that share a card use gloo)")
    dist.init_process_group(
        backend, init_method=init_method, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))
    return True


def _local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def world_size() -> int:
    """The ranks of the process group; 1 when none is initialised."""
    return dist.get_world_size() if dist.is_initialized() else 1


class OneRankMesh:
    """The ``("data", "model")`` mesh of one process with no process
    group: one rank at (0, 0) on the current device. Its groups are
    ``None``, so the solve is unsharded and the collectives return their
    inputs."""

    mesh_dim_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, device_type: str):
        self.device_type = device_type

    def size(self, dim: Optional[int] = None) -> int:
        return 1

    def get_group(self, name: str):
        return None

    def get_local_rank(self, name: str) -> int:
        return 0


def device_mesh(device_type: str, data: int, model: int):
    """A ``("data", "model")`` DeviceMesh over ranks ``0..data*model-1``
    (the whole world), rank ``r`` at ``(r // model, r % model)``. A CUDA
    rank's card is ``LOCAL_RANK`` modulo the cards visible; the mesh's
    groups must use the default group's backend. With no process group,
    a 1 x 1 layout is a :class:`OneRankMesh`."""
    from torch.distributed.device_mesh import init_device_mesh

    world = world_size()
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} != {world} ranks")
    if not dist.is_initialized():
        return OneRankMesh(device_type)
    if device_type == "cuda":
        torch.cuda.set_device(_local_rank() % torch.cuda.device_count())
        torch.zeros(1, device="cuda")          # the rank's context, now
    mesh = init_device_mesh(device_type, (data, model),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    want = dist.get_backend()
    for name in (DATA_AXIS, MODEL_AXIS):
        got = dist.get_backend(mesh.get_group(name))
        if got != want:
            raise RuntimeError(f"mesh group {name!r} uses {got}, not {want}")
    return mesh


def mesh_device(mesh) -> torch.device:
    """The device of this rank's shards."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def global_mesh(data: Optional[int] = None, model: Optional[int] = None,
                devices: str = "cuda"):
    """``("data", "model")`` mesh over every rank of every host, laid out so
    that the model axis is contiguous within a host and the data axis
    strides across hosts. Defaults: model = the ranks of one host
    (``LOCAL_WORLD_SIZE``, capped at the total), data = the rest.
    ``devices`` is the ranks' device type (``"cuda"`` or ``"cpu"``)."""
    n = world_size()
    if model is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        model = min(per_host, n) if data is None else max(n // data, 1)
    if data is None:
        data = max(n // model, 1)
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return device_mesh(devices, data, model)


def _data_coords(mesh):
    if mesh is not None:
        return (mesh.get_local_rank(DATA_AXIS),
                mesh.size(mesh.mesh_dim_names.index(DATA_AXIS)))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_local_batch(global_batch_size: int, mesh=None) -> tuple:
    """(start, stop, padded_total) rows of the global batch this rank loads:
    its data coordinate's share of the batch padded up to
    ``padded_total = ceil(B / n) * n`` (n = the data axis of ``mesh``, or
    every rank without one). Rows ≥ B are padding: load any valid row
    (e.g. replay row ``i % B``) and drop those outputs."""
    pid, pc = _data_coords(mesh)
    per = -(-global_batch_size // pc)
    return pid * per, (pid + 1) * per, per * pc


def pad_rows(x, total: int):
    """Pad a leading-batch-axis array up to ``total`` rows by replaying
    row 0 (companion to :func:`process_local_batch`)."""
    x = np.asarray(x)
    if x.shape[0] >= total:
        return x
    return np.concatenate([x, np.repeat(x[:1], total - x.shape[0], axis=0)])


def host_local_to_global(local, mesh, axis: str = DATA_AXIS):
    """Every rank's rows of ``local`` (numpy arrays or tensors, in nested
    tuples, named tuples or dicts; the batch leading every leaf) gathered
    over the mesh's ``axis`` group in coordinate order, on this rank's
    device: every rank then holds the global batch. With one rank (no
    group, or a group of one) it is a put on the device."""
    device = mesh_device(mesh)
    group = mesh.get_group(axis)

    def one(x):
        return all_gather_cat(torch.as_tensor(x).to(device), group)

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            items = [walk(v) for v in tree]
            return (type(tree)(*items) if hasattr(tree, "_fields")
                    else type(tree)(items))
        return one(tree)

    return walk(local)


# ---------------------------------------------------------------------------
# Starting ranks on one host.
# ---------------------------------------------------------------------------

def _rank_main(target, args, rank, n, backend, store, timeout_s, results):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(n))
    try:
        initialize(backend, store, n, rank, timeout_s)
        results.put((rank, True, target(*args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(target, n: int, backend: str, args=(), timeout_s: float = 600.0):
    """Run ``target(*args)`` in ``n`` new processes, ranks ``0..n-1`` of a
    process group (``backend``, a file store in a temporary directory, so
    no port is taken) on this host; returns their results in rank order.
    ``target`` must be importable by name and return picklable values
    (numpy arrays, not device tensors). Raises when a rank raises, or when
    the ranks have not all returned within ``timeout_s`` seconds; every
    process started is ended before this returns."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = "file://" + os.path.join(tmp, "store")
        results = ctx.Queue()
        procs = [ctx.Process(target=_rank_main, args=(
            target, args, r, n, backend, store, timeout_s, results))
            for r in range(n)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout_s
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{n - len(out)} of {n} ranks still "
                                       f"running after {timeout_s} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [r for r, p in enumerate(procs)
                            if r not in out and p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"ranks {dead} exited with "
                                           f"{[procs[r].exitcode for r in dead]}")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {n} failed:\n{value}")
                out[rank] = value
        finally:
            # after a failure the other ranks may wait in a collective:
            # end them now; after success give them time to exit
            for p in procs:
                p.join(timeout=30 if len(out) == n else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
        return [out[r] for r in range(n)]
