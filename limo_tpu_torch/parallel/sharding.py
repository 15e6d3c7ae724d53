"""Multi-device sharding of the windowed BA engine — the counterpart of the
reference package's ``limo_tpu/parallel/sharding.py``.

The reference splits a window over a ``("data", "model")`` mesh inside
``shard_map``:

- **data axis**: a batch of windows (one per sequence), split across
  groups of ranks; the groups share nothing;
- **model axis**: the landmark dimension of each window. Everything in the
  normal-equation assembly reduces over L (U, b_pose and cost, the Schur
  correction, the trim scores), so a landmark-sharded solve needs one
  ``all_reduce`` of the reduced system per assembly, one of the Schur
  correction per LM iteration, one gather of the [L] trim scores per trim
  round and summed counts (``axis`` in ``solver/``). The reduced pose
  system (P ≈ 200) is solved on every rank, as Ceres dense-solves it after
  Schur elimination.

Here a rank is one process, the mesh a ``torch.distributed``
``DeviceMesh`` (:func:`make_mesh`, over the initialised world), and each
rank holds its shard on its own device (:func:`shard_window`). Both CUDA
kernels run on every shard as they run on a whole window: they take any L,
so a shard needs no padding.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..solver.trimmed import solve_trimmed
from ..state import Selection, Window
from ..utils.collectives import all_gather_cat
from .multihost import (DATA_AXIS, MODEL_AXIS, device_mesh, mesh_device,
                        world_size)


def make_mesh(n_devices: Optional[int] = None, data: Optional[int] = None,
              device_type: str = "cuda"):
    """``("data", "model")`` mesh over the world's ``n_devices`` ranks
    (default: all of them; it must be all of them). With no hint, at most
    2 on data and the rest on model (landmark sharding is the primary
    within-window axis): data = 2 when n is even and at least 4. With no
    process group the world is one rank."""
    world = world_size()
    n = n_devices or world
    if n != world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if data is None:
        data = 2 if n % 2 == 0 and n >= 4 else 1
    return device_mesh(device_type, data, n // data)


def window_pspecs(batched: bool) -> Window:
    """Per leaf of a (batched) Window, the mesh axis that splits each
    leading dimension: landmark-major leaves split over MODEL_AXIS,
    keyframe leaves replicate, the batch dimension splits over DATA_AXIS."""
    b = (DATA_AXIS,) if batched else ()
    rep, lm = b, b + (MODEL_AXIS,)
    return Window(stamps=rep, poses=rep, kf_valid=rep, fix_pose=rep,
                  fix_scale=rep, planes=rep, plane_valid=rep,
                  lm_pos=lm, lm_valid=lm, lm_weight=lm, lm_has_depth=lm,
                  lm_is_gp=lm, lm_id=lm, obs=lm, obs_mask=lm)


def selection_pspecs(batched: bool) -> Selection:
    b = (DATA_AXIS,) if batched else ()
    lm = b + (MODEL_AXIS,)
    return Selection(lm_selected=lm, gp_kf=lm, gp_weight=lm, scale_kf0=b,
                     scale_kf1=b, scale_target=b, scale_weight=b,
                     plane_dist_fixed=b)


def _axis_size(mesh, axis):
    return mesh.size(mesh.mesh_dim_names.index(axis))


def _shard(tree, specs, mesh):
    device = mesh_device(mesh)

    def one(x, spec):
        for dim, axis in enumerate(spec):
            n, i = _axis_size(mesh, axis), mesh.get_local_rank(axis)
            if x.shape[dim] % n:
                raise ValueError(f"dimension {dim} of size {x.shape[dim]} "
                                 f"does not split over {n} ranks of {axis!r}")
            size = x.shape[dim] // n
            x = x.narrow(dim, i * size, size)
        return x.to(device).contiguous()

    return type(tree)(*[one(x, s) for x, s in zip(tree, specs)])


def _gather(tree, specs, mesh):
    def one(x, spec):
        for dim, axis in enumerate(spec):
            x = all_gather_cat(x, mesh.get_group(axis), dim)
        return x

    return type(tree)(*[one(x, s) for x, s in zip(tree, specs)])


def shard_window(window: Window, mesh, batched: bool = False) -> Window:
    """This rank's shard of ``window`` on its device: the contiguous
    L/model slice of its model coordinate (and B/data rows of its data
    coordinate when batched); raises when a split is not even."""
    return _shard(window, window_pspecs(batched), mesh)


def shard_selection(sel: Selection, mesh, batched: bool = False) -> Selection:
    return _shard(sel, selection_pspecs(batched), mesh)


def gather_window(window: Window, mesh, batched: bool = False) -> Window:
    """The whole window back from every rank's shard, on every rank."""
    return _gather(window, window_pspecs(batched), mesh)


def gather_selection(sel: Selection, mesh,
                     batched: bool = False) -> Selection:
    return _gather(sel, selection_pspecs(batched), mesh)


def make_sharded_solver(mesh, rig, cfg, batched: bool = True):
    """The landmark-sharded trimmed solve: :func:`make_shard_map_solver`,
    one code path for any mesh, as in the reference package."""
    return make_shard_map_solver(mesh, rig, cfg, batched=batched)


def make_shard_map_solver(mesh, rig, cfg, batched: bool = False):
    """Trimmed solve of this rank's shard, with explicit collectives over
    the mesh's model group: returns ``solve(window, sel) -> (window, sel,
    SolveInfo)`` on shards from :func:`shard_window` /
    :func:`shard_selection`. Landmark leaves of the result are the shard's;
    poses, planes and the SolveInfo are the same on every rank of the
    model group.

    With ``batched=True`` the shard carries a leading batch of windows (its
    data coordinate's rows): they are solved one after another, as the
    reference's ``lax.map`` does, each exiting at its own convergence, and
    the results are stacked (the SolveInfo's integer fields as tuples)."""
    group = mesh.get_group(MODEL_AXIS)
    device = mesh_device(mesh)
    rig = type(rig)(*[x.to(device) for x in rig])

    def solve(window, sel):
        return solve_trimmed(window, sel, rig, cfg, axis=group)

    if not batched:
        return solve

    def stack(items):
        first = items[0]
        if isinstance(first, torch.Tensor):
            return torch.stack(items)
        if isinstance(first, tuple):
            return type(first)(*[stack(list(f)) for f in zip(*items)])
        return tuple(items)

    def row(tree, b):
        return type(tree)(*[x[b] for x in tree])

    def solve_rows(windows, sels):
        outs = [solve(row(windows, b), row(sels, b))
                for b in range(windows.poses.shape[0])]
        return tuple(stack(list(part)) for part in zip(*outs))

    return solve_rows
