"""Multi-view multi-person 3D human pose estimation framework in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
AIS-Bonn/SmartEdgeSensor3DHumanPose (RSS 2021): per-camera 2D keypoint
detections (with covariance) are time-synchronized, associated across views
(iterative greedy epipolar matching + Hungarian assignment), triangulated
(confidence-weighted DLT with unscented covariance propagation), smoothed and
tracked (batched Levenberg-Marquardt skeleton prior replacing gtsam),
velocity-predicted, and reprojected into every camera view as semantic
feedback.

Everything on the compute path is a pure, fixed-shape array program over a
(cameras x people x joints) batch, designed for XLA's compilation model on
an accelerator (an NVIDIA GPU). The host-side runtime (time synchronizer,
replay queue) has a native C++ implementation. See SURVEY.md at the repo root for the layer map
of the reference this framework re-implements.
"""

from smartedgesensor3dhumanpose_tpu.config import (
    FusionConfig,
    PipelineConfig,
    PriorConfig,
    TrackerConfig,
)
from smartedgesensor3dhumanpose_tpu.types import (
    CameraRig,
    Frame,
    Persons3D,
    Reprojection2D,
    TrackerState,
)

__version__ = "0.1.0"

__all__ = [
    "CameraRig",
    "Frame",
    "FusionConfig",
    "Persons3D",
    "PipelineConfig",
    "PriorConfig",
    "Reprojection2D",
    "TrackerConfig",
    "TrackerState",
    "__version__",
]
