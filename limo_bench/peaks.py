"""Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, at its 700 W power
limit) and the least bytes each observation kernel's work needs.

Bytes count each input read once and each output written once, in
float32, for the keyframes and landmarks a window uses (K keyframes, L
landmarks, C cameras), whatever the kernel reads again or reads beyond
them: ``assemble_obs`` reads the observations and their two masks
(5·K·C per landmark), the landmarks and their weights (4 per landmark),
the poses (12 per keyframe) and the cameras (15 each), and writes V, b_l
(12 per landmark), W (18·K per landmark), U, b_pose (42 per keyframe) and
the cost; ``cost_obs`` reads the same and writes the cost. At K = 20, L =
1536, C = 1 these are 2,928,928 and 640,000 bytes.
"""

HBM_BYTES_PER_S = 3.35e12
F32 = 4


def obs_bytes(kernel: str, K: int, L: int, C: int) -> int:
    inputs = L * (5 * K * C + 4) + 12 * K + 15 * C
    if kernel == "assemble_obs":
        outputs = L * (12 + 18 * K) + 42 * K + 1
    elif kernel == "cost_obs":
        outputs = 1
    else:
        raise ValueError(f"no byte count for kernel {kernel!r}")
    return F32 * (inputs + outputs)


def launches(kernel: str, solve: dict) -> int:
    """Launches of ``kernel`` in one trimmed solve: an assembly per LM
    iteration; a cost per iteration, per trim round and the initial one."""
    if kernel == "assemble_obs":
        return solve["iterations"]
    return 1 + solve["iterations"] + solve["rounds"]


def roofline_share(record, kernel: str):
    """Percent of the HBM roofline that ``kernel`` reached over the traced
    window: the least time of the traced solves' launches over the device
    time of every operation launched inside the kernel's range (and of the
    kernel itself where the trace holds no launching call for it)."""
    if record.trace is None or not record.solves:
        return None
    dev_ms = record.trace["ranges"].get(f"limo.{kernel}", {}).get(
        "device_ms", 0.0) + sum(
        ms for name, ms in record.trace.get("unlinked_ms", {}).items()
        if f"{kernel}_kernel" in name)
    if dev_ms <= 0.0:
        return None
    least_s = sum(launches(kernel, s) * obs_bytes(kernel, s["K"], s["L"],
                                                  s["C"])
                  for s in record.solves) / HBM_BYTES_PER_S
    return 100.0 * least_s / (dev_ms / 1e3)
