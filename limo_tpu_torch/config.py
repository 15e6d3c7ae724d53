"""Typed config tree for the whole engine.

The PyTorch port keeps its own copy of the reference package's config so
that it imports nothing of that package; field names and defaults are the
same, so a config given as ``dataclasses.asdict`` carries across
(:func:`limo_tpu_torch.state.config_from_dict`).

One dataclass hierarchy replaces the reference's rosinterface_handler params +
launch YAML layers (``cfg/MonoLidar.rosif:34-92``,
``launch/keyframe_ba_monolid.launch:38-63``). Defaults follow the KITTI launch
values where those differ from the .rosif defaults (noted inline).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class CapacityConfig:
    """Static array capacities — tensors keep fixed shapes; the reference's own
    caps (window 20 kf, 300-per-bin landmarks) define natural bounds."""

    max_keyframes: int = 20          # max_size_optimization_window (rosif default)
    max_landmarks: int = 1536        # >= near+middle+far caps + gp guarantees
    max_cameras: int = 1
    max_obs_per_landmark: int = 20   # = max_keyframes (one obs per kf per cam)


@dataclass(frozen=True)
class RobustLossConfig:
    """Cauchy loss scales (``launch/keyframe_ba_monolid.launch:45,48``)."""

    depth_thres: float = 0.16         # robust_loss_depth_thres
    reprojection_thres: float = 1.6   # robust_loss_reprojection_thres
    depth_quantile: float = 0.95      # outlier_rejection_quantile
    reprojection_quantile: float = 0.95
    gp_quantile: float = 1.0          # gp family never trimmed (solve():757)
    num_trim_iterations: int = 1      # outer trim rounds (rosif: 1)
    min_residual_groups: int = 30     # skip trimming below this many landmarks
    trim_iteration_lm_steps: int = 2  # LM iterations per trim round (solve():745)
    # Per-family TrimmerSpecification (robust_solving.hpp:18-25,135-156):
    # each family dispatches Fix | Quantile. "quantile" uses the *_quantile
    # values above; "fixed" rejects groups whose max raw residual norm
    # exceeds the *_trim_fixed_thres value (TrimmerFix, trimmer_fix.hpp:36-47).
    depth_trimmer: str = "quantile"
    reprojection_trimmer: str = "quantile"
    gp_trimmer: str = "quantile"
    depth_trim_fixed_thres: float = 0.16
    reprojection_trim_fixed_thres: float = 1.6
    gp_trim_fixed_thres: float = 0.1


@dataclass(frozen=True)
class SolverConfig:
    """LM solver settings mirroring robust_optimization::Options
    (``robust_solving.hpp:76-108``) re-expressed for the on-device solver."""

    max_iterations: int = 100
    refinement_iterations: int = 20   # final refinement pass budget
    initial_lambda: float = 1e-4      # ~ 1/initial_trust_region_radius (1e4)
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    min_lambda: float = 1e-10
    max_lambda: float = 1e8
    function_tolerance: float = 1e-6  # ceres default
    reset_trust_region_each_round: bool = True  # trust_region_relaxation_factor=-10
    diverged_retry_factor: int = 3    # retry with 3x iterations on divergence
    # the hand-written CUDA assembly/cost kernels (solver/cuda_assemble.py);
    # False runs their plain PyTorch versions on the card
    use_pallas_assembly: bool = True
    # kept so that a reference config carries across; the port has no
    # interpreter mode and ignores it
    pallas_interpret: bool = False
    # Motion parameterization (setParameterization variants,
    # bundle_adjuster_keyframes.cpp:172-183): "full_dof" (production),
    # "fix_rotation", or "circular_2d" (the "Bycicle" planar-arc model,
    # CircularMotionPlus2d). Applied as a per-keyframe tangent basis.
    motion_parameterization: str = "full_dof"
    # Motion-only adjustment (adjustPoseOnly) budgets. The reference runs
    # <=4 LM iterations with rotation-compensated (RotRocc) reprojection
    # (bundle_adjuster_keyframes.cpp:66-75,832; cost_functors_ceres.hpp:
    # 130-148). Round-3 A/B (120-frame synthetic drives, host driver +
    # compiled scan pipeline; full table in PARITY.md §2.9):
    #   host driver:  RotRocc ON  0.073% drift / 0.23 m ATE
    #                 RotRocc OFF 1.72%  drift / 0.45 m ATE  → reference wins
    #   scan driver:  RotRocc ON  3.3-3.8% drift (divergent — the RotRocc
    #                 divisor shrinks cost as rotation grows, and the scan
    #                 path's constant-velocity prior can start outside the
    #                 safe basin);   RotRocc OFF 0.06% drift → OFF wins
    #   4 vs 8 iterations: identical on both drivers → reference budget 4.
    # Round-4 re-test (after the per-frame 5-point prior + plausibility
    # guards landed in the scan step, testing VERDICT r3's prediction that
    # the CV prior caused the divergence): 300-frame drives are now STABLE
    # with RotRocc ON (0.028-0.029% vs 0.018-0.019% off, either prior) —
    # the guards removed the hard divergence — but the 1200-frame km drive
    # still diverges (19.5% drift / 108 m ATE on vs 0.017% off): one
    # accepted RotRocc-biased step inside a curve compounds over hundreds
    # of window generations faster than the guards can reject it. The
    # prediction is refuted by measurement; the deviation stands.
    # Hence: host adjust_pose_only follows the reference exactly; the scan
    # pipeline keeps its own flag (below) defaulting to plain reprojection.
    pose_only_max_iterations: int = 4
    pose_only_compensate_rotation: bool = True
    scan_pose_only_compensate_rotation: bool = False
    # Graduated non-convexity for the SCAN path's motion-only solve: the
    # CV prior starts ~f·Δyaw px outside the Cauchy basin at sharp-turn
    # onset (the reference's per-frame 5-point prior never does), so the
    # first iterations run with the robust scales ×(this·2^-it), floor 1.
    # 1.0 = off (host driver / reference behavior). On the km rendered
    # drive's 62° turns the per-frame diagnostics show pose-only
    # recovering 3.0-8.6° deficits inside the ≤4-iteration budget with
    # this schedule active (docs/PERF.md km-drive failure chain; the
    # catastrophic failure itself was the frame-dependent plausibility
    # guard, fixed separately in scan_odometry).
    scan_pose_only_graduated_init: float = 8.0


@dataclass(frozen=True)
class KeyframeSelectionConfig:
    """Keyframe scheme params (``launch/keyframe_ba_monolid.launch:40-44``)."""

    min_median_flow: float = 5.0               # px; reject frame below (standstill)
    critical_quaternion_difference: float = 0.03  # rad; force-keep on curves
    time_between_keyframes_sec: float = 0.4


@dataclass(frozen=True)
class LandmarkSelectionConfig:
    """Landmark scheme params (``mono_lidar.cpp:379-485``, launch values)."""

    max_number_landmarks_near_bin: int = 200
    max_number_landmarks_middle_bin: int = 200
    max_number_landmarks_far_bin: int = 100
    # voxel scheme (``landmark_selection_scheme_voxel.hpp:25-37``)
    voxel_size_xyz: Tuple[float, float, float] = (0.5, 0.5, 0.3)
    roi_far_xyz: Tuple[float, float, float] = (40.0, 40.0, 40.0)
    roi_middle_xyz: Tuple[float, float, float] = (15.0, 15.0, 15.0)
    z_range: Tuple[float, float] = (-20.0, 100.0)  # passthrough band
    # AddDepth guarantee: >=50 gp landmarks per window frame (mono_lidar.cpp:424)
    min_number_landmarks_gp: int = 50
    # plausibility box (scheme exists; off by default as in reference)
    use_dimension_plausibility: bool = False
    height_over_ground: float = 0.31  # groundplane prior height (launch:58)


@dataclass(frozen=True)
class WindowConfig:
    """Windowing (``bundle_adjuster_keyframes.cpp:907-987`` semantics)."""

    min_num_connecting_landmarks: int = 18   # launch:54 (rosif default 30)
    min_size_optimization_window: int = 3
    max_size_optimization_window: int = 20
    time_between_solves_sec: float = 0.4     # throttle: solve every ~kf period


@dataclass(frozen=True)
class RegularizationConfig:
    """Weights hard-coded in the reference solve path."""

    scale_reg_weight_unobserved: float = 1000.0   # solve():712-716
    scale_reg_weight_observed_base: float = 1000.0  # / (n_depth + n_gp)
    gp_reg_weight: float = 10.0                   # addGroundplaneRegularization
    gp_height_weight: float = 10.0                # addGroundPlaneResiduals
    gp_height_huber_delta: float = 0.1
    gp_max_distance: float = 25.0                 # linear falloff range
    speed_reg_rotation_gate: float = 0.03         # adjustPoseOnly:835-853
    shrubbery_weight: float = 0.9                 # vegetation downweight


@dataclass(frozen=True)
class PriorConfig:
    """Motion prior (5-point essential) settings
    (``general_helpers.hpp:103-140,209-231``)."""

    default_speed: float = 13.0      # m/s mono fallback scale guess
    ransac_prob: float = 0.999
    ransac_thres_px: float = 1.0
    min_flow_px: float = 3.0         # below: assume standstill, identity motion
    num_hypotheses: int = 256        # batched RANSAC hypothesis count
    # ---- compiled scan-path prior (VERDICT r3 item 3) -------------------
    # "essential": a fresh per-frame 5-point prior vs the last keyframe
    # INSIDE the scan step — the reference's behavior (fresh 5-point every
    # frame, general_helpers.hpp:103-140, mono_lidar.cpp:155-187).
    # "constant_velocity": the motion-model prior + motion-only refinement.
    # Default is constant_velocity, a measured decision (r4 A/B, rendered
    # drives): on ground-dominated near-straight segments the per-frame
    # 5-point hits the planar two-fold (R,t) ambiguity and its cheirality
    # vote intermittently flips, shocking the pose chain (km-drive prefix:
    # 68 m error at f100 with essential vs 1.1 m with CV; on the curved
    # 200-frame gate scene the two are equal, 3.35% vs 3.39% on-chip) —
    # and it costs ~6 ms/frame. The reference NEEDS the 5-point because it
    # has no motion model between keyframes; the scan path's CV prior +
    # ≤4-iteration motion-only solve is the stronger equivalent. The
    # essential path stays selectable for reference-parity experiments.
    scan_prior_mode: str = "constant_velocity"
    # smaller hypothesis budget inside the compiled scan step (every frame
    # pays it; track-tensor correspondences are pre-matched so the inlier
    # ratio is far higher than raw OpenCV matches)
    scan_num_hypotheses: int = 64
    # ---- speed-derived plausibility budgets (VERDICT r4 item 4) ---------
    # The prior clamps and the motion-only/post-solve guards bound how far
    # a single frame may move the pose. r4 hard-coded 5 m / 0.2 rad, which
    # silently binds at speed: at 25 m/s (KITTI seq 01) the TRUE per-frame
    # displacement is 2.5 m and a legitimate BA correction after a few
    # coasted frames exceeds 5 m. The displacement budget is now derived
    # from the measured speed state (the reference's contract: translation
    # budgets scale with prior_speed, general_helpers.hpp:209-231 +
    # cfg/MonoLidar.rosif prior_speed — no fixed caps):
    #   budget_m(dt) = max(floor, factor × max(speed, floor_speed) × dt)
    # The floor keeps low-speed behavior identical to the measured-good r4
    # configuration (5 m at ≤12.5 m/s × 0.4 s keyframe gaps); the factor
    # gives BA/turn corrections ~4× the nominal per-frame motion of
    # headroom. Rotation budget stays absolute (0.2 rad/frame ≈ 11°, far
    # above any vehicle yaw rate; it guards heading flips, not dynamics).
    guard_speed_factor: float = 4.0
    guard_floor_m: float = 5.0
    guard_floor_speed: float = 3.0   # m/s; keeps budgets alive from rest
    guard_rotation_rad: float = 0.2
    # Lidar range-rate scale arbitration (the high-speed delusion loop,
    # docs/PERF.md high-speed section): a pose estimate is accepted only
    # when its implied speed sits within ±max(floor, frac·speed_obs) of
    # the per-slot lidar depth-rate median (when ≥ min_rates slots carry
    # depth in consecutive frames). The band must be TIGHT: a 40% band
    # measured at 25 m/s let accepted motion decay to 15 m/s, the matcher
    # prediction error then crossed the texture-aliasing cliff, and the
    # fully-aliased match field zeroed the range rate itself (ground
    # depth is position-invariant — an aliased static match field reads
    # speed 0). 15% keeps the prediction locked so the cliff is never
    # reached. The thesis is the reference's own: metric scale comes from
    # the lidar, not from image matching (monolidar_fusion).
    lidar_band_frac: float = 0.15
    lidar_band_floor_m_s: float = 2.0
    lidar_min_rates: int = 20


@dataclass(frozen=True)
class LimoConfig:
    capacity: CapacityConfig = field(default_factory=CapacityConfig)
    robust: RobustLossConfig = field(default_factory=RobustLossConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    keyframe_selection: KeyframeSelectionConfig = field(default_factory=KeyframeSelectionConfig)
    landmark_selection: LandmarkSelectionConfig = field(default_factory=LandmarkSelectionConfig)
    window: WindowConfig = field(default_factory=WindowConfig)
    regularization: RegularizationConfig = field(default_factory=RegularizationConfig)
    prior: PriorConfig = field(default_factory=PriorConfig)
    # solver time caps are CPU-scheduling artifacts in the reference; the
    # solver runs fixed iteration budgets instead (deterministic).

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


def default_config() -> LimoConfig:
    return LimoConfig()


def load_label_sets(path: str):
    """Load semantic label sets from the reference's YAML layout
    (``res/outlier_labels.yaml``: ``outlier_labels``/``shrubbery_labels``
    int lists + optional ``labels`` id→name map), with the same
    missing-field error as ``loadSetFromYaml``
    (general_helpers.hpp:31-42). Returns (outliers, shrubbery, names)."""
    import yaml

    with open(path) as f:
        root = yaml.safe_load(f) or {}
    out = {}
    for field_name in ("outlier_labels", "shrubbery_labels"):
        v = root.get(field_name)
        if not isinstance(v, list):
            raise ValueError(
                f"LabelReader: vector {field_name} not defined.")
        out[field_name] = frozenset(int(x) for x in v)
    names = {int(k): str(v) for k, v in (root.get("labels") or {}).items()}
    return out["outlier_labels"], out["shrubbery_labels"], names


def config_from_yaml(path: str, base: Optional[LimoConfig] = None) -> LimoConfig:
    """Overlay a nested YAML file onto the config tree — the replacement for
    the reference's launch-file param layering over .rosif defaults
    (``launch/keyframe_ba_monolid.launch:38-63``). Top-level keys name the
    sub-configs (``robust``, ``solver``, ...); unknown keys raise."""
    import yaml

    with open(path) as f:
        overrides = yaml.safe_load(f) or {}
    cfg = base or LimoConfig()
    valid_groups = {f.name for f in dataclasses.fields(LimoConfig)}
    updates = {}
    for group, kv in overrides.items():
        if group not in valid_groups:
            raise ValueError(f"unknown config group {group!r} "
                             f"(valid: {sorted(valid_groups)})")
        sub = getattr(cfg, group)
        kv = kv or {}  # a group header with no keys is a no-op
        field_names = {f.name for f in dataclasses.fields(sub)}
        bad = set(kv) - field_names
        if bad:
            raise ValueError(f"unknown keys {sorted(bad)} in group {group!r}")
        kv = {k: tuple(v) if isinstance(v, list) else v for k, v in kv.items()}
        updates[group] = dataclasses.replace(sub, **kv)
    return dataclasses.replace(cfg, **updates)


def kitti_config() -> LimoConfig:
    """Values from ``launch/keyframe_ba_monolid.launch`` (production KITTI)."""
    cfg = LimoConfig(
        window=WindowConfig(
            min_num_connecting_landmarks=18,
            max_size_optimization_window=12,
            time_between_solves_sec=0.4,
        ),
    )
    return cfg
