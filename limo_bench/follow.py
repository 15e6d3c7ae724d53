"""``correct``: the plain reference (``reference/plain.py``) judges the
program's frames one by one.

The program's drives are chaotic in float32 (a rounding at a keyframe gate
or in an ill-posed solve parts two runs for good), so no reference can run
a whole drive beside the program and land on the same frames. Instead, on
frames drawn from the seed, the reference starts from the program's own
state before the frame (cast to float64) with the frame's inputs, works
out what the frame has to give, and judges the program's outputs, its next
state and, on a solve frame, the solve's input and output by that:

- ``flips``: keyframe, solve and post-solve guard decisions and keyframe
  counts that differ from what the reference's rules decide from the
  program's own motion-only result; rows of the solve input's newest
  keyframe whose observation is not the frame's; fields of the program's
  initial state that are not the empty state; a solve loop that breaks
  the configuration's rounds or budgets (all exact);
- ``pose_m``: metres between the program's motion-only result and the
  reference's (the nearest of its paths: where float32 rounding decides
  one of the solve's tests, the reference follows both outcomes), and
  ``emit_m``, between the pose the frame emits, the next state's pose and
  the solve input's newest keyframe and what the reference's rules make
  of the program's own motion-only result and solve output: the widest;
- ``pose_cost``: how far the program's motion-only result raises the
  frame's motion-only cost (over the landmarks that path's last
  iterations used) above the reference's: the relative excess, the
  widest;
- on frames where both run a trimmed solve, from the program's own solve
  input: ``step1_rel``, the first Levenberg-Marquardt iteration: where the
  program accepts it, the gap between its cost and the reference's
  candidate's, and how far that candidate raises the cost; where it
  rejects it, how far the reference's candidate lowers it; ``final_rel``,
  the program's final cost against the reference's cost of the window the
  solve returns; ``cost0_rel``, the program's initial cost against the
  reference's (read); and in ``flips``, the solve's loop as its
  ``SolveInfo`` traces it against the configuration's rounds and budgets
  (``plain.loop_flips``).

What this skips, the frames between the compared ones, is judged on other
runs: the compared frames are drawn anew from each seed over the whole
pass. The landmark selection that leads to a solve is the program's: the
reference judges the solve from the program's input and takes the
program's final trimmed selection for its cost.
"""

from __future__ import annotations

import sys

import numpy as np

from .reference import plain

NUMBERS = ("flips", "pose_m", "pose_cost", "step1_rel", "final_rel",
           "emit_m", "cost0_rel")


def to_np(tree):
    """A program NamedTuple as a dict of NumPy arrays, floats in float64
    (the clock's stamps kept in float32)."""
    out = {}
    for name, v in zip(tree._fields, tree):
        if hasattr(v, "_fields"):
            out[name] = to_np(v)
            continue
        a = v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)
        if a.dtype.kind == "f" and "stamp" not in name:
            a = a.astype(np.float64)
        out[name] = a
    return out


def trans_gap(a, b) -> float:
    """Metres between two vehicle<-origin poses' origins."""
    return float(np.linalg.norm(plain.relative(np.asarray(a, np.float64),
                                               np.asarray(b, np.float64))[4:]))


def sample_frames(seed, kinds, frame_ms, n_solve, n_track):
    """The compared frames of the first pass, drawn from the seed: the
    longest solve frame, more solve frames, and frames without a solve."""
    rng = np.random.default_rng([seed, 0x5CA7])
    solve = [i for i, k in enumerate(kinds) if k == "solve"]
    track = [i for i, k in enumerate(kinds) if k == "track"]
    picked = []
    if solve:
        longest = max(solve, key=lambda i: frame_ms[i])
        rest = [i for i in solve if i != longest]
        picked = [longest] + list(rng.choice(
            rest, size=min(n_solve - 1, len(rest)), replace=False))
    picked += list(rng.choice(track, size=min(n_track, len(track)),
                              replace=False))
    return sorted(int(i) for i in picked)


def start_flips(st, default_speed) -> int:
    """Fields of the program's initial state that are not the empty
    state: no keyframe, landmark or selection, the identity pose and
    motion, the default speed, the clock's stamps far in the past."""
    w = st["window"]
    ident = np.array([1.0, 0, 0, 0, 0, 0, 0])
    checks = [not w["kf_valid"].any(), not w["lm_valid"].any(),
              not w["obs_mask"].any(), not st["sel_mask"].any(),
              not st["lm_outlier"].any(), int(st["n_kf"]) == 0,
              np.array_equal(st["cur_pose"], ident),
              np.array_equal(st["vel"], ident),
              np.array_equal(st["last_kf_pose"], ident),
              float(st["speed"]) == float(np.float32(default_speed)),
              not st["last_kf_uv_valid"].any(), not st["last_d_valid"].any()]
    checks += [float(st[k]) <= -1e8 for k in
               ("last_kf_stamp", "last_solve_stamp", "last_stamp")]
    return sum(not c for c in checks)


def rows(numbers, limits):
    """(name, value, limit) of every number: the cell's limit where its
    file sets one (the number is compared), else None (printed beside the
    compared ones, to read; it decides nothing)."""
    return [(n, float(v), None if n not in limits else float(limits[n]))
            for n, v in numbers.items()]


def newest_slot(w) -> int:
    stamps = np.where(w["kf_valid"], w["stamps"].astype(np.float64), -np.inf)
    return int(np.argmax(stamps))


def judge(frames, cfg, cam, inputs, states, outs, solves):
    """Judge the program's ``frames`` (indices into the first pass).
    ``cfg`` the configuration as dicts of its groups, ``cam`` a
    ``plain.Camera``, ``inputs`` = (stamps, uvd, valid) of the pass;
    ``states[i]`` / ``states[i + 1]`` the program's ScanState before /
    after frame i, ``outs[i]`` its FrameOut, ``solves[i]`` (input window,
    input selection, (window, selection, SolveInfo)) where it ran a
    solve. Returns {number: value}."""
    stamps, uvd_all, valid_all = inputs
    solver = cfg["solver"]
    numbers = dict.fromkeys(NUMBERS, 0.0)
    motion_gaps = []
    for i in frames:
        st = to_np(states[i])
        nxt = to_np(states[i + 1])
        out = to_np(outs[i])
        uvd = uvd_all[i].astype(np.float64)
        valid = valid_all[i].astype(bool)
        ref = plain.frame(st, stamps[i], uvd, valid, cam, cfg)
        # the program's frame pose, made of its own motion-only result by
        # the guard, decides the keyframe and the solve
        refined = ref["guard"](out["refined"])
        take_kf, do_solve = ref["decide"](refined)
        prog_solved = i in solves
        numbers["flips"] += int(take_kf != bool(out["is_keyframe"]))
        numbers["flips"] += int(do_solve != prog_solved)
        numbers["flips"] += int(int(nxt["n_kf"]) != int(st["n_kf"]) + take_kf)
        # the motion-only result against the reference's path nearest it
        pose, cost = min(ref["paths"], key=lambda pc: trans_gap(
            out["refined"], pc[0]))
        motion_gaps.append(trans_gap(out["refined"], pose))
        c_ref = cost(pose)
        if c_ref > 0:       # 0 before the first keyframe: no landmark
            numbers["pose_cost"] = max(numbers["pose_cost"], (cost(
                out["refined"]) - c_ref) / c_ref)
        emitted = refined
        if prog_solved:
            w_in, sel_in, (w_out, sel_out, info) = solves[i]
            w_in, sel_in = to_np(w_in), to_np(sel_in)
            w_out, sel_out = to_np(w_out), to_np(sel_out)
            # the push: the solve input's newest keyframe is this frame
            k = newest_slot(w_in)
            numbers["emit_m"] = max(numbers["emit_m"],
                                    trans_gap(w_in["poses"][k], refined))
            seen = w_in["obs_mask"][:, k, 0]
            numbers["flips"] += int(np.sum(seen != valid))
            numbers["flips"] += int(np.sum(np.abs(w_in["obs"][:, k, 0] - uvd)[
                seen] > 1e-3 * (1 + np.abs(uvd[seen]))))
            # the post-solve guard
            ok = ref["solve_ok"](w_out["poses"][k], refined)
            numbers["flips"] += int(ok != bool(out["solved"]))
            if ok:
                emitted = w_out["poses"][k]
        numbers["emit_m"] = max(numbers["emit_m"],
                                trans_gap(out["pose"], emitted),
                                trans_gap(nxt["cur_pose"], emitted))
        if not prog_solved:
            continue
        # the solve stage, from the program's own input
        p = plain.Problem(w_in, sel_in, cam, cfg)
        c0, cand = p.first_step(solver["initial_lambda"])
        numbers["cost0_rel"] = max(numbers["cost0_rel"],
                                   abs(float(info.initial_cost) - c0) / c0)
        c1 = float(info.cost_trace[0])
        if int(info.accept_trace[0]) == 1:
            e = max(abs(c1 - cand) / cand, (cand - c0) / c0)
        else:
            e = (c0 - cand) / c0
        numbers["step1_rel"] = max(numbers["step1_rel"], e)
        q = plain.Problem(w_out, sel_out, cam, cfg)
        c_out = q.cost_of(w_out)
        numbers["final_rel"] = max(numbers["final_rel"],
                                   abs(float(info.final_cost) - c_out) / c_out)
        numbers["flips"] += plain.loop_flips(to_np(info), cfg)
        print(f"solve frame {i}: cost0 {float(info.initial_cost):.6f} / "
              f"{c0:.6f}; first step {c1:.6f} (accept "
              f"{int(info.accept_trace[0])}) / candidate {cand:.6f}; final "
              f"{float(info.final_cost):.6f} / {c_out:.6f}; iterations "
              f"{info.n_iterations}, rounds {info.n_rounds}, trimmed "
              f"{int(info.n_trimmed)}", file=sys.stderr)
    numbers["pose_m"] = max(motion_gaps + [numbers["emit_m"]])
    print(f"motion-only gaps (m) {['%.3g' % x for x in motion_gaps]}",
          file=sys.stderr)
    return numbers
