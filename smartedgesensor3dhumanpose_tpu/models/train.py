"""Training for the on-device keypoint detector on synthetic hall scenes.

The reference never trains anything in-repo (its 2D CNNs live on the edge
sensors); this module makes the beyond-reference end-to-end variant
(models/end_to_end.py) demonstrably functional: it renders synthetic camera
images from the ground-truth scene generator (io/synthetic), trains the
heatmap CNN on them (MSE on rendered Gaussian targets, optax Adam), and
returns parameters good enough that pixels -> detector -> fusion -> 3D
lands within centimeters of the scene ground truth
(tests/test_models.py::test_end_to_end_trained_pixels_to_3d).

Joints are color-coded in the synthetic renderer — each joint id maps to a
fixed RGB color — so a small backbone can learn the joint identities from
local appearance, which is the property the real edge-sensor CNNs provide.
"""

from __future__ import annotations

from typing import Any, Tuple

import jax
import jax.numpy as jnp
import numpy as np
import optax

from smartedgesensor3dhumanpose_tpu.models import keypoint_cnn


def joint_colors(num_joints: int = 17) -> np.ndarray:
    """[J, 3] distinct RGB colors in (0, 1] (golden-ratio hue wheel)."""
    cols = []
    for j in range(num_joints):
        h = (j * 0.61803398875) % 1.0
        i = int(h * 6.0)
        f = h * 6.0 - i
        v, p, q, t = 1.0, 0.25, 1.0 - 0.75 * f, 0.25 + 0.75 * f
        rgb = [
            (v, t, p), (q, v, p), (p, v, t), (p, q, v), (t, p, v), (v, p, q)
        ][i % 6]
        cols.append(rgb)
    return np.asarray(cols, np.float32)


def render_images(
    kp2d: jnp.ndarray,
    kp_valid: jnp.ndarray,
    image_size: Tuple[int, int],
    radius: float = 3.0,
    noise: float = 0.02,
    rng_key=None,
) -> jnp.ndarray:
    """Render color-coded joint disks into synthetic camera images.

    Args:
      kp2d: [C, D, J, 2] pixel keypoints.
      kp_valid: [C, D, J] bool.
      image_size: (H, W).

    Returns:
      [C, H, W, 3] images in [0, 1].
    """
    h, w = image_size
    j = kp2d.shape[-2]
    cols = jnp.asarray(joint_colors(j))
    yy = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    xx = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)

    def one_cam(kps, ok):
        # kps [D, J, 2]; blob intensity per joint: max over detections.
        d2 = (yy[None, None] - kps[..., 1][..., None, None]) ** 2 + (
            xx[None, None] - kps[..., 0][..., None, None]
        ) ** 2  # [D, J, H, W]
        blob = jnp.exp(-d2 / (2.0 * radius**2))
        blob = jnp.where(ok[..., None, None], blob, 0.0)
        inten = jnp.max(blob, axis=0)  # [J, H, W]
        img = jnp.einsum("jhw,jc->hwc", inten, cols)
        return jnp.clip(img, 0.0, 1.0)

    imgs = jax.vmap(one_cam)(kp2d, kp_valid)
    if rng_key is not None and noise > 0:
        imgs = jnp.clip(
            imgs + noise * jax.random.normal(rng_key, imgs.shape), 0.0, 1.0
        )
    return imgs


def make_training_batch(scene_frames_np, t, cam_sel, det_cfg, rng_key):
    """One batch of (images, target heatmaps) from a synthetic scene's
    pixel keypoints (io/synthetic.frames_from_scene output)."""
    kp2d = jnp.asarray(scene_frames_np["kp2d"][t][cam_sel])  # [B, D, J, 3]
    det_valid = jnp.asarray(scene_frames_np["det_valid"][t][cam_sel])
    kp_valid = det_valid[..., None] & (kp2d[..., 2] > 0)
    images = render_images(
        kp2d[..., :2], kp_valid, det_cfg.image_size, rng_key=rng_key
    )
    targets = keypoint_cnn.gaussian_targets(kp2d[..., :2], kp_valid, det_cfg)
    return images, targets


def train_detector(
    det_cfg: keypoint_cnn.DetectorConfig,
    scene_frames_np,
    steps: int = 300,
    batch_cams: int = 4,
    lr: float = 2e-3,
    seed: int = 0,
    log_every: int = 0,
) -> Tuple[keypoint_cnn.KeypointCNN, Any, float]:
    """Train the detector on rendered synthetic frames.

    Returns (model, trained params, final loss).
    """
    rng = jax.random.PRNGKey(seed)
    rng, init_key = jax.random.split(rng)
    model, params = keypoint_cnn.init_detector(det_cfg, init_key)
    tx = optax.adam(lr)
    opt_state = tx.init(params)

    num_frames = scene_frames_np["kp2d"].shape[0]
    num_cams = scene_frames_np["kp2d"].shape[1]

    @jax.jit
    def step_fn(params, opt_state, images, targets):
        loss, grads = jax.value_and_grad(
            lambda p: keypoint_cnn.heatmap_loss(model, p, images, targets)
        )(params)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    np_rng = np.random.default_rng(seed)
    loss = float("nan")
    for it in range(steps):
        t = int(np_rng.integers(0, num_frames))
        cam_sel = np_rng.choice(num_cams, size=batch_cams, replace=False)
        rng, key = jax.random.split(rng)
        images, targets = make_training_batch(
            scene_frames_np, t, cam_sel, det_cfg, key
        )
        params, opt_state, loss = step_fn(params, opt_state, images, targets)
        if log_every and (it % log_every == 0):
            print(f"step {it}: loss {float(loss):.6f}")
    return model, params, float(loss)
