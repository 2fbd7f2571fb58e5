"""Configuration dataclasses.

The reference distributes its knobs over roslaunch args, rosparam private
params and compile-time constants (see
reference skeleton_3d/src/skeleton_3d_triang_mult_node.cpp:56-64,1095-1126 and
pose_prior/src/pose_prior_mult_node.cpp:46-66,930-937). Here every knob lives
in one frozen dataclass tree so that a config instance can parameterize the
jitted pipeline as static data.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

# The values of FusionConfig.assignment_impl (fusion.resolve_assignment_impl).
ASSIGNMENT_IMPLS = ("auto", "cond_while", "triton")


@dataclasses.dataclass(frozen=True)
class FusionConfig:
    """Multi-view association + triangulation stage (reference skeleton_3d).

    Default values mirror the reference node's constants
    (skeleton_3d_triang_mult_node.cpp:56-64,149) and the demo launch file
    (pose_prior/launch/pose_triangulate_demo.launch:5).
    """

    num_cameras: int = 16
    # Fixed padded sizes (the reference uses dynamic std::vectors; XLA needs
    # static shapes + validity masks).
    max_dets_per_cam: int = 8
    max_hypotheses: int = 16

    pose_method: str = "simple"  # "simple" (COCO-17) or "h36m"
    # Confidence threshold for a 2D keypoint to participate in association /
    # triangulation (g_triangulation_threshold, :58).
    min_kp_score: float = 0.30
    # Detections need strictly more than half of the input joints valid (:579).
    # Symmetric epipolar gate in normalized image coords (:60; demo uses 0.045).
    max_epipolar_error: float = 0.050
    # Reprojection error gate triggering outlier rejection (:59).
    reproj_error_max_acceptable: float = 0.050
    # Person-level gate on the number of valid fused keypoints (:57).
    min_num_valid_keypoints: int = 9
    # Joints farther than this from the root are dropped (:61).
    max_joint_dist_to_root: float = 2.0
    # Feet must be within +-50cm of the ground plane (:963).
    max_feet_height: float = 0.50
    # Skeletons closer (mean joint distance) than this are merged (:62).
    merge_dist_thresh: float = 0.20
    # Cameras more than this behind the pivot stamp are masked out (:64).
    max_sync_diff: float = 0.067
    # Sigma for the limb-length-model covariance inflation (:149).
    limb_cov_offset_sigma: float = 0.075
    # Unscented-transform scaling for 2D->3D covariance propagation (:475).
    ut_kappa: float = 0.5
    # Cost assigned to infeasible pairings (MAX_COSTS, :43).
    max_cost: float = 1.0e6
    # Implementation of the association fold (fusion.associate):
    #  "auto" (default): resolved per backend and shape by
    #    fusion.resolve_assignment_impl — "triton" on a GPU, "cond_while"
    #    elsewhere,
    #  "cond_while": XLA camera scan with a while-loop JV behind a
    #    lax.cond so the solver only executes on ambiguous frames (the
    #    reference the kernel is tested against),
    #  "triton": the whole fold as one Pallas-Triton kernel program per
    #    frame (ops.association_triton; needs a GPU).
    assignment_impl: str = "auto"

    def __post_init__(self) -> None:
        if self.assignment_impl not in ASSIGNMENT_IMPLS:
            raise ValueError(
                f"assignment_impl {self.assignment_impl!r} is not one of "
                f"{ASSIGNMENT_IMPLS}"
            )

    @property
    def num_input_joints(self) -> int:
        return 17

    @property
    def num_fusion_joints(self) -> int:
        return 21


@dataclasses.dataclass(frozen=True)
class PriorConfig:
    """Skeleton-model smoothing stage (reference pose_prior, gtsam LM).

    Defaults mirror pose_prior_mult_node.cpp:46-66 and gtsam 4.0.3's
    LevenbergMarquardtParams defaults.
    """

    pose_method: str = "simple"
    normalize_by_height: bool = False
    # Minimum keypoint score to enter the factor graph (g_min_score, :50).
    min_score: float = 0.10
    # Root unary covariance is shrunk by this factor squared to pin the
    # skeleton's global position (g_root_sigma_factor, :52).
    root_sigma_factor: float = 100.0
    # Fallback isotropic result sigma when marginals are indeterminate (:48).
    default_res_sigma: float = 0.10
    # Sigma multiplier for limb lengths; x2 when height-normalized (:934-937).
    # None -> derived from normalize_by_height.
    limb_sigma_factor: Optional[float] = None
    # Default height when the neck is unobserved in normalized mode (:666).
    default_height: float = 0.60
    # Levenberg-Marquardt schedule (gtsam defaults: initial lambda 1e-5,
    # factor 10, relative/absolute error tolerance 1e-5).
    lm_initial_lambda: float = 1.0e-5
    lm_lambda_factor: float = 10.0
    lm_lambda_upper: float = 1.0e5
    lm_max_iterations: int = 32
    lm_relative_error_tol: float = 1.0e-5
    lm_absolute_error_tol: float = 1.0e-5
    # Linear solver for the LM normal equations + marginals:
    #  "tree": level-grouped block elimination along the bone forest
    #    (ops/tree_solve.py) — identical math, ~6 batched 3x3 levels instead
    #    of a batched 63x63 Cholesky.
    #  "dense": equilibrated 63x63 Cholesky (oracle / cross-check path).
    solver: str = "tree"

    @property
    def effective_limb_sigma_factor(self) -> float:
        if self.limb_sigma_factor is not None:
            return self.limb_sigma_factor
        return 2.0 if self.normalize_by_height else 1.0


@dataclasses.dataclass(frozen=True)
class TrackerConfig:
    """Temporal track management + velocity prediction (reference pose_prior).

    Defaults mirror pose_prior_mult_node.cpp:47-66.
    """

    max_tracks: int = 24
    # Tracks die after this many seconds without observation (:62).
    max_unobserved_time: float = 1.0
    # Gate on the velocity-sigma-normalized association distance (:63).
    dist_threshold: float = 5.0
    # Tracks closer than this (mean joint distance) are merged (:64).
    merge_dist_thresh: float = 0.20
    # Number of observations before a track is published (:66).
    min_num_obs: int = 10
    # Moving-average window for velocities and feedback delay (g_n_mov_avg, :53).
    n_mov_avg: int = 3
    # Default average pipeline delay seeding the prediction horizon (:51).
    avg_delay: float = 0.10
    # Prediction noise sigma added to predicted covariances (:47).
    pred_noise_sigma: float = 0.12
    # Cost for infeasible track/detection pairings (MAX_DIST, :65).
    max_dist: float = 1.0e6


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    """Full closed-loop pipeline: fusion -> prior/tracking -> reprojection."""

    fusion: FusionConfig = dataclasses.field(default_factory=FusionConfig)
    prior: PriorConfig = dataclasses.field(default_factory=PriorConfig)
    tracker: TrackerConfig = dataclasses.field(default_factory=TrackerConfig)
    # Compute dtype for the on-device hot path; tests exercise float64 on
    # CPU against the same code.
    dtype: str = "float32"

    def __post_init__(self) -> None:
        if self.fusion.pose_method != self.prior.pose_method:
            raise ValueError(
                "fusion.pose_method and prior.pose_method must agree, got "
                f"{self.fusion.pose_method!r} vs {self.prior.pose_method!r}"
            )

    @staticmethod
    def demo_16cam(**overrides) -> "PipelineConfig":
        """The 16-camera / 6-person hall demo configuration
        (pose_triangulate_demo.launch:2-6)."""
        fusion = FusionConfig(num_cameras=16, max_epipolar_error=0.045)
        return PipelineConfig(fusion=fusion, **overrides)

    @staticmethod
    def scaled_64cam(**overrides) -> "PipelineConfig":
        """Scaled synthetic hall: 64 cameras x 25 people (BASELINE.json)."""
        fusion = FusionConfig(
            num_cameras=64,
            max_dets_per_cam=32,
            max_hypotheses=40,
            max_epipolar_error=0.045,
        )
        tracker = TrackerConfig(max_tracks=64)
        return PipelineConfig(fusion=fusion, tracker=tracker, **overrides)
