"""Lightweight on-device 2D keypoint CNN (heatmap head) + decoder.

The reference's 2D pose CNNs run on the smart edge sensors themselves
(Google EdgeTPU boards, README.md:7-11) and only their keypoint/covariance
messages reach this system. For the fully-fused end-to-end variant (pixels
in, BASELINE.json configs), this module provides an equivalent detector
that runs on the same device as the fusion pipeline:

* a small bfloat16 convolutional backbone + heatmap head (channel counts in
  multiples of 128 where it matters, a width the tensor cores tile well),
* a fixed-slot multi-person decoder: D peaks per camera via iterative
  masked argmax (greedy NMS), each refined to sub-pixel by a local
  soft-argmax, with per-keypoint confidence and 2x2 covariance from the
  local heatmap moments — exactly the Keypoint2D(+cov) message the fusion
  stage ingests.

Everything is pure JAX/flax; the detector composes with fusion.fuse_frame
inside one jit (models.end_to_end).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Tuple

import flax.linen as nn
import jax
import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    num_joints: int = 17
    image_size: Tuple[int, int] = (480, 640)  # (H, W)
    heatmap_stride: int = 8
    width: int = 128  # base channel count
    depth: int = 4    # conv stages in the backbone
    max_detections: int = 6
    # Peak decoding.
    nms_radius: int = 12       # heatmap pixels suppressed around a peak
    window: int = 5            # soft-argmax window (odd)
    min_peak_score: float = 0.1
    # Channels averaged for person seeding (None -> all joints). Compact
    # root joints (e.g. the COCO hips, (11, 12)) give one clean peak per
    # person instead of a body-wide blob.
    seed_joints: Tuple[int, ...] | None = None
    # Search radius (heatmap cells) for a person's joints around its seed;
    # None -> nms_radius. Widen it (with a compact seed, e.g. the hips) when
    # a body extends further than the seed blob.
    joint_radius: int | None = None
    param_dtype: Any = jnp.float32
    compute_dtype: Any = jnp.bfloat16


class KeypointCNN(nn.Module):
    """Conv backbone + per-joint heatmap head.

    Input:  [B, H, W, 3] images in [0, 1].
    Output: [B, H/stride, W/stride, J] heatmaps (sigmoid activations).
    """

    cfg: DetectorConfig

    @nn.compact
    def __call__(self, x):
        cfg = self.cfg
        x = x.astype(cfg.compute_dtype)
        width = cfg.width
        strides_left = cfg.heatmap_stride
        for i in range(cfg.depth):
            stride = 2 if strides_left > 1 else 1
            strides_left = max(1, strides_left // 2)
            x = nn.Conv(
                width,
                (3, 3),
                strides=(stride, stride),
                dtype=cfg.compute_dtype,
                param_dtype=cfg.param_dtype,
                name=f"conv{i}",
            )(x)
            x = nn.GroupNorm(
                num_groups=8, dtype=cfg.compute_dtype, name=f"gn{i}"
            )(x)
            x = nn.relu(x)
            width = min(2 * width, 256)
        x = nn.Conv(
            cfg.num_joints,
            (1, 1),
            dtype=cfg.compute_dtype,
            param_dtype=cfg.param_dtype,
            name="head",
        )(x)
        return nn.sigmoid(x.astype(jnp.float32))


def decode_heatmaps(
    heatmaps: jnp.ndarray, cfg: DetectorConfig
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Fixed-slot multi-person decoding of per-joint heatmaps.

    Person peaks are seeded from the joint-mean heatmap (greedy masked argmax
    with a suppression radius — the jittable equivalent of NMS); each seed
    claims, per joint, the dominant response inside its neighborhood and
    refines it with a local soft-argmax. Confidence = peak activation; the
    2x2 covariance comes from the local second moments (scaled to pixels) —
    the uncertainty the fusion stage propagates through the UT.

    Args:
      heatmaps: [B, Hh, Wh, J].

    Returns:
      (kp2d [B, D, J, 3] pixel (x, y, score),
       cov2d [B, D, J, 3] packed (xx, xy, yy),
       det_score [B, D],
       det_valid [B, D])
    """
    b, hh, wh, j = heatmaps.shape
    d = cfg.max_detections
    stride = cfg.heatmap_stride
    win = cfg.window
    half = win // 2

    yy = jax.lax.broadcasted_iota(jnp.int32, (hh, wh), 0)
    xx = jax.lax.broadcasted_iota(jnp.int32, (hh, wh), 1)

    if cfg.seed_joints is not None:
        person_map = jnp.mean(
            heatmaps[..., jnp.asarray(cfg.seed_joints)], axis=-1
        )
    else:
        person_map = jnp.mean(heatmaps, axis=-1)  # [B, Hh, Wh]
    joint_radius = (
        cfg.joint_radius if cfg.joint_radius is not None else cfg.nms_radius
    )

    def find_peaks(pmap):
        def body(carry, _):
            pm, _ = carry
            idx = jnp.argmax(pm.reshape(-1))
            py, px = idx // wh, idx % wh
            score = pm.reshape(-1)[idx]
            # Suppress the claimed neighborhood.
            suppress = (jnp.abs(yy - py) <= cfg.nms_radius) & (
                jnp.abs(xx - px) <= cfg.nms_radius
            )
            pm = jnp.where(suppress, -1.0, pm)
            return (pm, None), (py, px, score)

        (_, _), peaks = jax.lax.scan(
            body, (pmap, None), None, length=d
        )
        return peaks  # (py [D], px [D], score [D])

    pys, pxs, pscores = jax.vmap(find_peaks)(person_map)  # [B, D]

    # Per seed and joint: local window around the seed in that joint's map.
    def window_at(hm_j, cy, cx):
        """hm_j: [Hh, Wh]; returns the (win, win) patch clamped in-bounds."""
        cy = jnp.clip(cy - half, 0, hh - win)
        cx = jnp.clip(cx - half, 0, wh - win)
        return (
            jax.lax.dynamic_slice(hm_j, (cy, cx), (win, win)),
            cy,
            cx,
        )

    wy = jax.lax.broadcasted_iota(jnp.float32, (win, win), 0)
    wx = jax.lax.broadcasted_iota(jnp.float32, (win, win), 1)

    def decode_joint(hm_j, seed_y, seed_x):
        # The joint's response near the person seed: masked argmax inside a
        # joint_radius box (a body extends further than the compact seed).
        near = (jnp.abs(yy - seed_y) <= joint_radius) & (
            jnp.abs(xx - seed_x) <= joint_radius
        )
        masked = jnp.where(near, hm_j, -1.0)
        idx = jnp.argmax(masked.reshape(-1))
        jy, jx = idx // wh, idx % wh
        peak = masked.reshape(-1)[idx]
        patch, oy, ox = window_at(hm_j, jy, jx)
        wsum = jnp.maximum(jnp.sum(patch), 1e-6)
        my = jnp.sum(patch * wy) / wsum
        mx = jnp.sum(patch * wx) / wsum
        # Second moments -> pixel covariance (heatmap cells -> pixels).
        vyy = jnp.sum(patch * (wy - my) ** 2) / wsum
        vxx = jnp.sum(patch * (wx - mx) ** 2) / wsum
        vxy = jnp.sum(patch * (wy - my) * (wx - mx)) / wsum
        px_x = (ox + mx) * stride + (stride - 1) / 2.0
        px_y = (oy + my) * stride + (stride - 1) / 2.0
        s2 = float(stride * stride)
        return px_x, px_y, peak, vxx * s2, vxy * s2, vyy * s2

    def decode_person(hms, seed_y, seed_x):
        # hms: [Hh, Wh, J]
        return jax.vmap(decode_joint, in_axes=(2, None, None))(
            hms, seed_y, seed_x
        )

    def decode_image(hms, pys_i, pxs_i):
        return jax.vmap(decode_person, in_axes=(None, 0, 0))(
            hms, pys_i, pxs_i
        )

    px_x, px_y, peak, vxx, vxy, vyy = jax.vmap(decode_image)(
        heatmaps, pys, pxs
    )  # each [B, D, J]

    score = jnp.where(peak > cfg.min_peak_score, peak, 0.0)
    kp2d = jnp.stack([px_x, px_y, score], axis=-1)
    cov2d = jnp.stack(
        [jnp.maximum(vxx, 0.25), vxy, jnp.maximum(vyy, 0.25)], axis=-1
    )
    cov2d = jnp.where(score[..., None] > 0, cov2d, 0.0)
    det_valid = pscores > cfg.min_peak_score
    det_score = jnp.where(det_valid, pscores, 0.0)
    return kp2d, cov2d, det_score, det_valid


def init_detector(cfg: DetectorConfig, rng_key) -> Tuple[KeypointCNN, Any]:
    model = KeypointCNN(cfg)
    h, w = cfg.image_size
    params = model.init(rng_key, jnp.zeros((1, h, w, 3), jnp.float32))
    return model, params


def detect(
    model: KeypointCNN, params, images: jnp.ndarray, cfg: DetectorConfig
):
    """images [B, H, W, 3] -> fusion-ready detections (see decode_heatmaps)."""
    heatmaps = model.apply(params, images)
    return decode_heatmaps(heatmaps, cfg)


def heatmap_loss(
    model: KeypointCNN,
    params,
    images: jnp.ndarray,
    target_heatmaps: jnp.ndarray,
) -> jnp.ndarray:
    """MSE heatmap training loss (standard heatmap-regression objective)."""
    pred = model.apply(params, images)
    return jnp.mean((pred - target_heatmaps) ** 2)


def gaussian_targets(
    kp2d: jnp.ndarray,
    valid: jnp.ndarray,
    cfg: DetectorConfig,
    sigma: float = 2.0,
) -> jnp.ndarray:
    """Render ground-truth keypoints into training heatmaps.

    Args:
      kp2d: [B, D, J, 2] pixel keypoints.
      valid: [B, D, J] bool.

    Returns:
      [B, Hh, Wh, J] max-combined Gaussians.
    """
    h, w = cfg.image_size
    hh, wh = h // cfg.heatmap_stride, w // cfg.heatmap_stride
    yy = jax.lax.broadcasted_iota(jnp.float32, (hh, wh), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (hh, wh), 1)
    cy = (kp2d[..., 1] - (cfg.heatmap_stride - 1) / 2.0) / cfg.heatmap_stride
    cx = (kp2d[..., 0] - (cfg.heatmap_stride - 1) / 2.0) / cfg.heatmap_stride
    d2 = (yy[None, None, None] - cy[..., None, None]) ** 2 + (
        xx[None, None, None] - cx[..., None, None]
    ) ** 2  # [B, D, J, Hh, Wh]
    g = jnp.exp(-d2 / (2.0 * sigma**2))
    g = jnp.where(valid[..., None, None], g, 0.0)
    return jnp.transpose(jnp.max(g, axis=1), (0, 2, 3, 1))
