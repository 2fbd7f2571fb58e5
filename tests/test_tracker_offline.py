"""The offline tracker stage must reproduce per-frame tracking steps.

`pipeline.track_frames` is the sequential tracker `Pipeline.run_offline`
runs (a `lax.scan` over the batched cold-start smoothing); here it is
compared with a Python loop of `tracking.step` calls, one jitted step per
frame with the same precomputed smoothing. Integer decisions — publish
masks, person ids, spawn/drop counts, track lifecycle — must be exactly
equal, floats equal to 1e-5. Scenarios cover spawn churn, capacity overflow
(dropped spawns), decay, detection-free frames, close-track merges with id
inheritance, and the 64-track scaled layout.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smartedgesensor3dhumanpose_tpu import pipeline, tracking
from smartedgesensor3dhumanpose_tpu.config import (
    PipelineConfig,
    PriorConfig,
    TrackerConfig,
)
from smartedgesensor3dhumanpose_tpu.types import Persons3D, TrackerState

F32 = jnp.float32


def _synthetic_person_seq(rng, f, p, merge_heavy=False):
    """Fabricated fusion outputs: wandering people with teleports (spawn
    churn), random dropouts, detection-free frames, and optional tight
    clusters (track merges)."""
    k = 21
    base = rng.uniform(-3, 3, size=(p, 3))
    xyz = np.zeros((f, p, k, 3))
    score = np.zeros((f, p, k))
    valid = np.zeros((f, p), bool)
    pos = base.copy()
    for t in range(f):
        pos = pos + rng.normal(scale=0.02, size=(p, 3))
        # Teleports force track loss + respawn.
        jump = rng.uniform(size=p) < 0.08
        pos[jump] = rng.uniform(-3, 3, size=(jump.sum(), 3))
        if merge_heavy and t > f // 3:
            pos[: p // 2] = pos[0] + rng.normal(scale=0.02, size=(p // 2, 3))
        offs = rng.normal(scale=0.25, size=(p, k, 3))
        xyz[t] = pos[:, None, :] + offs
        xyz[t, :, :, 2] += 0.9  # keep roughly upright
        score[t] = rng.uniform(0.3, 1.0, size=(p, k))
        score[t][rng.uniform(size=(p, k)) < 0.15] = 0.0
        valid[t] = rng.uniform(size=p) > 0.25
        if rng.uniform() < 0.1:
            valid[t] = False  # detection-free frame
    cov = np.broadcast_to(np.eye(3) * 4e-3, (f, p, k, 3, 3)).copy()
    cov += rng.uniform(0, 1e-3, size=(f, p, 1, 1, 1)) * np.eye(3)
    return Persons3D(
        xyz=jnp.asarray(xyz, F32),
        score=jnp.asarray(score, F32),
        cov=jnp.asarray(cov, F32),
        valid=jnp.asarray(valid),
        person_id=-jnp.ones((f, p), jnp.int32),
    )


def _assert_match(ref, got):
    (st_ref, out_ref), (st, out) = ref, got

    def exact(name, a, b):
        np.testing.assert_array_equal(
            np.asarray(a), np.asarray(b), err_msg=name
        )

    def close(name, a, b):
        a = np.asarray(a, np.float64)
        b = np.asarray(b, np.float64)
        both_inf = np.isinf(a) & np.isinf(b) & (np.sign(a) == np.sign(b))
        np.testing.assert_allclose(
            np.where(both_inf, 0.0, a), np.where(both_inf, 0.0, b),
            rtol=0, atol=1e-5, err_msg=name,
        )

    exact("publish", out_ref.fused.valid, out.fused.valid)
    exact("person_id", out_ref.fused.person_id, out.fused.person_id)
    exact("pred ids", out_ref.fused_pred.person_id, out.fused_pred.person_id)
    exact("n_dropped_spawns", out_ref.n_dropped_spawns, out.n_dropped_spawns)
    close("pred_delta_t", out_ref.pred_delta_t, out.pred_delta_t)
    close("fused.xyz", out_ref.fused.xyz, out.fused.xyz)
    close("fused_pred.xyz", out_ref.fused_pred.xyz, out.fused_pred.xyz)
    close("fused_pred.cov", out_ref.fused_pred.cov, out.fused_pred.cov)
    for name in ("alive", "track_id", "num_obs", "next_id", "frame_nr",
                 "est_exists"):
        exact(name, getattr(st_ref, name), getattr(st, name))
    for name in ("estimate", "vel_buffer", "t_prev", "height_prev",
                 "root_prev", "fb_delay_buffer", "t_prev_global"):
        close(name, getattr(st_ref, name), getattr(st, name))


@pytest.mark.parametrize(
    "f,p,max_tracks,min_num_obs,merge_heavy,seed",
    [
        (30, 5, 8, 3, False, 0),    # spawn churn + decay, spare capacity
        (30, 6, 6, 3, False, 1),    # capacity pressure -> dropped spawns
        (30, 8, 12, 3, True, 2),    # tight clusters -> merges + id rewrite
        (10, 30, 64, 2, False, 7),  # the 64-track scaled layout
    ],
)
def test_offline_tracker_matches_per_frame_steps(
    f, p, max_tracks, min_num_obs, merge_heavy, seed
):
    rng = np.random.default_rng(seed)
    prior_cfg = PriorConfig()
    cfg = TrackerConfig(max_tracks=max_tracks, min_num_obs=min_num_obs)
    config = PipelineConfig(prior=prior_cfg, tracker=cfg)
    n_cams = 4
    persons = _synthetic_person_seq(rng, f, p, merge_heavy=merge_heavy)
    pivots = jnp.asarray(
        np.arange(f) / 30.0 + rng.normal(scale=1e-3, size=f), F32
    )
    fb = jnp.asarray(
        np.where(
            rng.uniform(size=(f, n_cams)) < 0.8,
            rng.uniform(0.05, 0.2, size=(f, n_cams)),
            -1.0,
        ),
        F32,
    )
    state0 = TrackerState.initial(
        cfg.max_tracks, cfg.n_mov_avg, cfg.avg_delay, dtype=F32
    )
    pre = jax.jit(lambda ps: pipeline.smooth_frames(ps, config, 8))(persons)

    got = jax.jit(
        lambda s, ps, pv, fd, pr: pipeline.track_frames(
            s, ps, pv, fd, pr, config
        )
    )(state0, persons, pivots, fb, pre)

    step = jax.jit(
        functools.partial(
            tracking.step, prior_cfg=prior_cfg, cfg=cfg
        )
    )
    st, outs = state0, []
    for t in range(f):
        at = lambda a: a[t]  # noqa: E731
        st, out = step(
            st,
            jax.tree.map(at, persons),
            pivots[t],
            fb[t],
            precomputed=jax.tree.map(at, pre),
        )
        outs.append(out)
    ref = (st, jax.tree.map(lambda *xs: jnp.stack(xs), *outs))

    _assert_match(ref, got)
    # The fixture must be non-trivial: something published, something died.
    assert int(np.asarray(ref[1].fused.valid).sum()) > 0
    if max_tracks == p:
        assert int(np.asarray(ref[1].n_dropped_spawns).sum()) > 0
