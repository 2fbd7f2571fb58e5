"""Multi-chip sharding equivalence on the virtual 8-device CPU mesh."""

import jax
import jax.numpy as jnp
import numpy as np

from smartedgesensor3dhumanpose_tpu import pipeline
from smartedgesensor3dhumanpose_tpu.io import synthetic
from smartedgesensor3dhumanpose_tpu.parallel import sharding
from test_pipeline import scene_frames, small_config


def _setup(n_frames=8, cams=8, people=2):
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(
            num_cameras=cams,
            num_people=people,
            num_frames=n_frames,
            pixel_noise=1.0,
            seed=17,
        )
    )
    cfg = small_config(cams, people)
    frames = scene_frames(scene, dtype=jnp.float64)
    return scene, cfg, frames


def test_mesh_construction():
    assert len(jax.devices()) == 8, "conftest must force an 8-device CPU mesh"
    mesh = sharding.make_mesh(8, model=2)
    assert mesh.shape == {"data": 4, "model": 2}
    mesh1 = sharding.make_mesh(8)
    assert mesh1.shape == {"data": 8, "model": 1}


def test_sharded_matches_single_device():
    scene, cfg, frames = _setup()
    pipe = pipeline.Pipeline(scene["rig"], cfg)
    state = pipe.init_state(dtype=jnp.float64)
    _, want = pipe.run_offline(state, frames)

    for model in (1, 2):
        mesh = sharding.make_mesh(8, model=model)
        _, got = sharding.run_offline_sharded(
            scene["rig"], cfg, mesh, frames, state
        )
        np.testing.assert_allclose(
            np.asarray(got.persons_raw.xyz),
            np.asarray(want.persons_raw.xyz),
            atol=1e-9,
            err_msg=f"model={model}",
        )
        np.testing.assert_array_equal(
            np.asarray(got.fused.valid), np.asarray(want.fused.valid)
        )
        np.testing.assert_allclose(
            np.asarray(got.fused.xyz),
            np.asarray(want.fused.xyz),
            atol=1e-8,
        )
        np.testing.assert_allclose(
            np.asarray(got.feedback.kp2d),
            np.asarray(want.feedback.kp2d),
            atol=1e-6,
        )


def test_fuse_frame_sharded_equivalence_and_collectives():
    """Within-frame sharding (camera axis -> all_gather -> hypothesis axis)
    must match the unsharded fusion AND actually distribute: the compiled
    HLO must contain an all-gather/all-reduce collective.

    Positions are compared at 1e-6: GSPMD partitions the normal-matrix
    contraction differently, and the DLT's homogeneous solve amplifies the
    resulting last-ulp reduction-order differences by the (squared) design
    conditioning — observed <= 1e-7 absolute, far inside the 1 mm parity
    budget. Discrete outputs (validity, i.e. association + gates) must
    still match exactly."""
    from smartedgesensor3dhumanpose_tpu import fusion

    cams, people = 24, 5
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(
            num_cameras=cams,
            num_people=people,
            num_frames=1,
            pixel_noise=1.0,
            seed=3,
        )
    )
    cfg = small_config(cams, people)
    frames = scene_frames(scene, dtype=jnp.float64)
    frame = jax.tree.map(lambda a: a[0], frames)
    frame, _ = pipeline.mask_stale_cameras(frame, cfg.fusion.max_sync_diff)

    want = fusion.fuse_frame(frame, scene["rig"], cfg.fusion,
                             unroll_cameras=True)

    mesh = sharding.make_mesh(8, model=8, data=1)
    fn = jax.jit(
        lambda fr: sharding.fuse_frame_sharded(
            fr, scene["rig"], cfg, mesh, axis="model"
        )
    )
    got = fn(frame)
    np.testing.assert_array_equal(
        np.asarray(got.valid), np.asarray(want.valid)
    )
    np.testing.assert_allclose(
        np.asarray(got.xyz), np.asarray(want.xyz), rtol=0, atol=1e-6
    )
    # Sharded UT reductions reorder float adds (near-zero cross terms make
    # relative bounds meaningless).
    np.testing.assert_allclose(
        np.asarray(got.cov), np.asarray(want.cov), rtol=0, atol=1e-8
    )

    hlo = fn.lower(frame).compile().as_text()
    assert ("all-gather" in hlo) or ("all-reduce" in hlo), (
        "sharded fusion compiled without collectives - the constraints are "
        "not load-bearing"
    )


def test_dryrun_multichip_entrypoint():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_dryrun_multichip_driver_env():
    """The entry point must be self-sufficient WITHOUT conftest's env.

    Mimics the driver environment (round-1 failure mode): a parent process
    whose jax sees exactly ONE device and whose backends are already
    initialized. dryrun_multichip must self-provision its virtual mesh.
    """
    import os
    import subprocess
    import sys

    repo = os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(sharding.__file__)))
    )
    env = dict(os.environ)
    # One CPU device, like a one-card machine; no forced count.
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = " ".join(
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    )
    code = (
        "import jax\n"
        "assert len(jax.devices()) == 1, jax.devices()\n"  # driver-like
        "import __graft_entry__ as g\n"
        "g.dryrun_multichip(8)\n"
        "print('DRIVER-ENV DRYRUN OK')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=repo,
        env=env,
        capture_output=True,
        text=True,
        timeout=1500,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "DRIVER-ENV DRYRUN OK" in proc.stdout
