from .ba_core import NormalEqs, ResidualStats, assemble, assembly_plan, plane_boxplus
from .lm import apply_step, run_lm, solve_normal_equations
from .pose_only import PoseOnlyResult, pose_only_step
from .trimmed import SolveInfo, solve_trimmed

__all__ = [
    "NormalEqs", "ResidualStats", "assemble", "assembly_plan", "plane_boxplus",
    "apply_step", "run_lm", "solve_normal_equations",
    "PoseOnlyResult", "pose_only_step",
    "SolveInfo", "solve_trimmed",
]
