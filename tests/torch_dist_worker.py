"""Rank processes of the port's multi-process tests (tests/test_torch_
{sharding,multihost,entry,solver_modes}.py), started by ``limo_tpu_torch.parallel.spawn``
over ``gloo`` on the CPU.

Each function runs in every rank of a fresh process (one torch thread, as
``torch_parity`` pins it in the test processes), after the process group
is up, and returns numpy arrays and Python values; the tests compare them
in the parent. Nothing here imports JAX or the reference package.
"""

import numpy as np
import torch
import torch.distributed as dist

from limo_tpu_torch import robust
from limo_tpu_torch.parallel import (gather_selection, gather_window,
                                     global_mesh, host_local_to_global,
                                     make_mesh, make_shard_map_solver,
                                     pad_rows, process_local_batch,
                                     shard_selection, shard_window)
from limo_tpu_torch.parallel.sharding import MODEL_AXIS
from limo_tpu_torch.pipeline import scan_odometry as so
from limo_tpu_torch.solver import solve_trimmed

# every quantile trim case: (quantile, fraction valid)
TRIM_CASES = ((0.5, 1.0), (0.9, 0.7), (0.25, 0.3))


def _numpy(tree):
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else v for k, v in tree._asdict().items()}


def _solve(mesh, w, sel, rig, cfg, batched=False):
    ws = shard_window(w, mesh, batched)
    ss = shard_selection(sel, mesh, batched)
    out_w, out_s, info = make_shard_map_solver(mesh, rig, cfg, batched)(ws,
                                                                        ss)
    return {"window": _numpy(gather_window(out_w, mesh, batched)),
            "selected": gather_selection(out_s, mesh, batched)
            .lm_selected.numpy(),
            "info": _numpy(info)}


def sharded_solves(w, sel, rig, cfg, scores):
    """On 4 ranks: the solve over model = 4 (data = 1), over model = 2 on
    each data group of a 2 x 2 mesh, the 2 x 2 batched solve of two equal
    windows, and ``trim_quantile`` on each rank's shard of ``scores``
    with the model group."""
    torch.set_num_threads(1)
    stacked = lambda t: type(t)(*[torch.stack([x, x]) for x in t])
    mesh4 = make_mesh(4, data=1, device_type="cpu")
    mesh22 = make_mesh(4, device_type="cpu")
    out = {"meshes": [(m.size(0), m.size(1)) for m in (mesh4, mesh22)],
           "model4": _solve(mesh4, w, sel, rig, cfg),
           "model2": _solve(mesh22, w, sel, rig, cfg),
           "batched": _solve(mesh22, stacked(w), stacked(sel), rig, cfg,
                             batched=True)}
    group = mesh4.get_group(MODEL_AXIS)
    n, r = dist.get_world_size(group), dist.get_rank(group)
    size = scores.shape[0] // n
    shard = slice(r * size, (r + 1) * size)
    rng = np.random.default_rng(3)
    trims = []
    for q, frac in TRIM_CASES:
        valid = torch.as_tensor(rng.uniform(size=scores.shape[0]) < frac)
        s = torch.as_tensor(scores)
        trims.append((
            robust.trim_quantile(s[shard], valid[shard], q, group).numpy(),
            robust.trim_quantile(s, valid, q)[shard].numpy()))
    out["trims"] = trims
    return out


def rotrocc_sharded_solve(w, sel, rig, cfg):
    """On every rank of a model-only mesh: the rotation-compensated trimmed
    solve of this rank's landmark shard, gathered."""
    torch.set_num_threads(1)
    mesh = make_mesh(dist.get_world_size(), data=1, device_type="cpu")
    out_w, out_s, info = solve_trimmed(
        shard_window(w, mesh), shard_selection(sel, mesh), rig, cfg,
        compensate_rotation=True, axis=mesh.get_group(MODEL_AXIS))
    return {"window": _numpy(gather_window(out_w, mesh)),
            "selected": gather_selection(out_s, mesh).lm_selected.numpy(),
            "info": _numpy(info)}


def mh_scenario(rig, cfg, seqs):
    """On 2 ranks: the reference's tests/mh_worker.py scenario (a batch of
    3 over 2 processes padded to 4, the global sum), then a fleet of
    ``seqs`` (stamps, uvd, valid) rows loaded per process, run there and
    gathered on every rank."""
    torch.set_num_threads(1)
    mesh = global_mesh(data=2, model=1, devices="cpu")
    B = 3
    start, stop, total = process_local_batch(B, mesh)
    replay = np.arange(total, dtype=np.float32) % B
    local = (replay[:, None] * np.ones((1, 8), np.float32))[start:stop]
    glob = host_local_to_global(local, mesh)
    summed = glob[:, 0].sum()
    n = len(seqs)
    fs, fstop, ftotal = process_local_batch(n, mesh)
    mine = [pad_rows(np.stack([s[i] for s in seqs]), ftotal)[fs:fstop]
            for i in range(3)]
    final, frames = so.run_fleet(*mine, rig, cfg, dtype=torch.float64,
                                 devices=["cpu"])
    fleet = host_local_to_global((final.window, frames), mesh)
    return {"batch": (start, stop, total), "global_shape": tuple(glob.shape),
            "global": glob.numpy(), "sum": float(summed),
            "fleet_rows": (fs, fstop, ftotal),
            "fleet": [_numpy(part) for part in fleet]}


def dryrun_stage(name):
    """One stage of ``entry.dryrun_multichip`` on a mesh of every rank."""
    from limo_tpu_torch import entry

    torch.set_num_threads(1)
    mesh = make_mesh(device_type="cpu")
    return getattr(entry, f"dryrun_{name}")(mesh)


def diverge():
    """Rank 0 enters a collective that rank 1 never enters."""
    if dist.get_rank() == 0:
        dist.all_reduce(torch.ones(1))
    return dist.get_rank()
