"""Guards of the on-device parity harness (parity.py).

The harness itself runs on the GPU in chip_smoke.py and bench.py (full
oracle differential); here we pin the cheap host-side invariants so a bench.py
edit that drifts the reused outputs fails in CI, not in the artifact.
"""

import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import parity  # noqa: E402


def _fake_outs(t, p, j, c):
    return SimpleNamespace(
        fused=SimpleNamespace(xyz=np.zeros((t, p, j, 3), np.float32)),
        feedback=SimpleNamespace(kp2d=np.zeros((t, c, p, j, 2), np.float32)),
    )


def test_full_parity_rejects_mismatched_outs():
    """run_full_parity(outs=...) must refuse outputs whose shapes do not
    match its own scene/config — BEFORE any oracle work runs."""
    _, data, config = parity._full_scene_and_config(adversarial=True)
    t, c = data["kp2d"].shape[:2]
    p = config.tracker.max_tracks

    # Wrong frame count (a bench edit shrinking the adversarial run).
    with pytest.raises(ValueError, match="diverged"):
        parity.run_full_parity(
            adversarial=True, outs=_fake_outs(t - 8, p, 21, c)
        )
    # Wrong person capacity (a config drift).
    with pytest.raises(ValueError, match="diverged"):
        parity.run_full_parity(
            adversarial=True, outs=_fake_outs(t, p + 4, 21, c)
        )
    # Wrong camera count in the feedback echo.
    with pytest.raises(ValueError, match="diverged"):
        parity.run_full_parity(
            adversarial=True, outs=_fake_outs(t, p, 21, c - 4)
        )


def test_full_parity_guard_accepts_matching_shapes():
    """Correctly-shaped outputs pass the guard (failure, if any, must come
    from the comparison itself, not the shape check)."""
    _, data, config = parity._full_scene_and_config(adversarial=True)
    t, c = data["kp2d"].shape[:2]
    p = config.tracker.max_tracks
    outs = _fake_outs(t, p, 21, c)
    # Stop right after the guard: _full_outputs_np will fault on the fake
    # object's missing fields, proving the guard itself let it through.
    with pytest.raises(AttributeError):
        parity.run_full_parity(adversarial=True, outs=outs)
