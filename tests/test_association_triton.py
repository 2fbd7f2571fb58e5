"""The Triton association fold around its kernel: backend choice, launch
arguments, padding, its JV, and (on a GPU only) the compiled kernel.

The kernel's arithmetic is pinned to the XLA fold in the Pallas interpreter
by test_association_pallas.py; the `gpu`-marked test here compiles it for
the card and compares it with the XLA cond_while fold on the same device.
`check_compiled_fold_matches_xla` is also called by chip_smoke.py at the
16x6 and 64x25 widths.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from smartedgesensor3dhumanpose_tpu import cameras as cameras_lib
from smartedgesensor3dhumanpose_tpu import fusion
from smartedgesensor3dhumanpose_tpu.config import FusionConfig
from smartedgesensor3dhumanpose_tpu.io import synthetic
from smartedgesensor3dhumanpose_tpu.ops import association_triton, hungarian

_STATIC = dict(
    gate=0.045, max_cost=1.0e6, clip=1.0e3, tie_eps=1.0e-3,
    invalid_cost=2.0e3,
)


@pytest.mark.parametrize(
    "backend,h,d,want",
    [
        ("gpu", 12, 6, "triton"),
        ("gpu", 40, 32, "triton"),
        ("gpu", 200, 32, "cond_while"),  # tiles past the register budget
        ("cpu", 12, 6, "cond_while"),
        ("rocm", 12, 6, "cond_while"),
    ],
)
def test_auto_resolution_per_backend(monkeypatch, backend, h, d, want):
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert fusion.resolve_assignment_impl("auto", h, d) == want
    # Explicit choices are literal on every backend.
    for impl in ("cond_while", "triton"):
        assert fusion.resolve_assignment_impl(impl, h, d) == impl


def test_removed_options_are_rejected():
    for impl in ("pallas", "pallas_scan", "unrolled", "bogus"):
        with pytest.raises(ValueError, match="assignment_impl"):
            FusionConfig(assignment_impl=impl)


@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_interpret_is_never_implied(monkeypatch, backend):
    """Whatever the backend says, the kernel launches compiled unless the
    caller passes interpret=True."""
    seen = []
    real = association_triton.pl.pallas_call

    def spy(*args, **kwargs):
        seen.append(kwargs["interpret"])
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(association_triton.pl, "pallas_call", spy)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    jax.clear_caches()  # trace afresh: the spy sees every launch
    ctab = -jnp.ones((1, 2, 6, 3), jnp.float32)
    args = (ctab, jnp.zeros((1, 6)), jnp.zeros((1, 2, 3), bool))
    jax.eval_shape(
        lambda *a: association_triton.associate_fold_batched(
            *a, h_cap=4, **_STATIC
        ),
        *args,
    )
    jax.eval_shape(
        lambda *a: association_triton.associate_fold_batched(
            *a, h_cap=4, interpret=True, **_STATIC
        ),
        *args,
    )
    assert seen == [False, True]


@pytest.mark.parametrize(
    "h,d,cams,want",
    [
        (12, 6, 16, (16, 16, 1)),   # the 16x6 deployment
        (40, 32, 64, (64, 64, 8)),  # the 64x25 scaled hall
        (15, 3, 5, (16, 8, 1)),     # max(H, D) + 1 is already a power of 2
        (4, 9, 3, (16, 4, 1)),      # more detections than hypotheses
    ],
)
def test_fold_tile_shapes(h, d, cams, want):
    assert association_triton.fold_shape(h, d, cams) == want


def test_fold_unpads_outputs():
    """Padded [S, Cp] kernel state comes back as [B, H, C]; an empty frame
    spawns nothing and every slot stays unobserved."""
    b, cams, d, h = 3, 5, 3, 6
    ctab = -jnp.ones((b, cams, cams * d, d), jnp.float64)
    det_ok = jnp.zeros((b, cams, d), bool).at[1, 2, 1].set(True)
    ds, nh, nd = association_triton.associate_fold_batched(
        ctab, jnp.zeros((b, cams * d)), det_ok, h_cap=h, interpret=True,
        **_STATIC,
    )
    assert ds.shape == (b, h, cams) and ds.dtype == jnp.int32
    assert nh.shape == nd.shape == (b,)
    np.testing.assert_array_equal(np.asarray(nh), [0, 1, 0])
    np.testing.assert_array_equal(np.asarray(nd), [0, 0, 0])
    want = np.full((b, h, cams), -1)
    want[1, 0, 2] = 1  # the lone detection seeds hypothesis 0
    np.testing.assert_array_equal(np.asarray(ds), want)


@pytest.mark.parametrize("r,c", [(5, 5), (12, 6), (4, 9), (16, 16)])
def test_kernel_jv_matches_xla_jv(rng, r, c):
    """The kernel's padded-vector JV returns the XLA solver's assignment,
    ties included (its argmin keeps the first index)."""
    n = max(r, c)
    s = association_triton.fold_shape(r, c, 1)[0]
    for trial in range(4):
        cost = rng.uniform(size=(r, c))
        if trial % 2:
            cost = np.round(cost * 3) / 3  # many exact ties
        want = np.asarray(
            hungarian.linear_sum_assignment(jnp.asarray(cost), unroll=False)
        )
        sq = np.zeros((s, s))
        sq[:r, :c] = cost
        col = np.asarray(association_triton._jv(jnp.asarray(sq), n, s))[:r]
        np.testing.assert_array_equal(np.where(col < c, col, -1), want)


def _fold_inputs(num_cameras, num_people, num_frames, max_dets, seed, **kw):
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(
            num_cameras=num_cameras,
            num_people=num_people,
            num_frames=num_frames,
            seed=seed,
            **kw,
        )
    )
    data = synthetic.frames_from_scene(scene, dtype=np.float32)
    pad = max_dets - data["kp2d"].shape[2]
    assert pad >= 0

    def padded(a, value=0):
        widths = [(0, 0)] * a.ndim
        widths[2] = (0, pad)
        return np.pad(a, widths, constant_values=value)

    rig = scene["rig"]
    kp2d = jnp.asarray(padded(data["kp2d"]))
    cov2d = jnp.asarray(padded(data["cov2d"]))
    det_score = jnp.asarray(padded(data["det_score"]))
    det_valid = jnp.asarray(padded(data["det_valid"], False))

    def one(kp, cov, score, valid):
        kp_n, cov_n, kp_ok = cameras_lib.normalize_keypoints(
            kp, cov, rig.K, 0.30
        )
        enough = jnp.sum(kp_ok, axis=-1) > 8
        return kp_n, cov_n, score, valid & enough

    return rig, jax.vmap(one)(kp2d, cov2d, det_score, det_valid)


def check_compiled_fold_matches_xla(
    num_cameras, num_people, max_dets, max_hypotheses, num_frames=8,
    seed=3, **scene_kw
):
    """The kernel as compiled for the default backend vs the cond_while XLA
    fold on the same device, float32, over `num_frames` frames vmapped (the
    offline pipeline's batching): every integer result equal."""
    rig, inputs = _fold_inputs(
        num_cameras, num_people, num_frames, max_dets, seed, **scene_kw
    )
    config = FusionConfig(
        num_cameras=num_cameras,
        max_dets_per_cam=max_dets,
        max_hypotheses=max_hypotheses,
        max_epipolar_error=0.045,
    )

    def run(impl):
        cfg = dataclasses.replace(config, assignment_impl=impl)
        fold = jax.jit(
            jax.vmap(
                lambda kp, cov, sc, ok: fusion.associate(
                    kp, cov, sc, ok, rig, cfg
                )
            )
        )
        return jax.tree.map(np.asarray, fold(*inputs))

    got, want = run("triton"), run("cond_while")
    np.testing.assert_array_equal(got.cam_mask, want.cam_mask)
    np.testing.assert_array_equal(got.kp, want.kp)
    np.testing.assert_array_equal(got.n_hyp, want.n_hyp)
    np.testing.assert_array_equal(got.n_dropped, want.n_dropped)
    assert want.n_hyp.min() > 0
    return {
        "frames": num_frames,
        "hypotheses_max": int(want.n_hyp.max()),
        "dropped": int(want.n_dropped.sum()),
    }


@pytest.mark.gpu
@pytest.mark.parametrize(
    "cams,people,dets,hyps,kw",
    [
        (16, 6, 6, 12, {}),
        (16, 6, 8, 12, dict(num_ghost_slots=2, ghost_rate=0.5,
                            identity_swap_rate=0.15)),
        (64, 25, 32, 40, {}),
    ],
)
def test_compiled_fold_matches_xla_fold(gpu, cams, people, dets, hyps, kw):
    check_compiled_fold_matches_xla(cams, people, dets, hyps, **kw)
