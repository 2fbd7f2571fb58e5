"""Track management, smoothing, and velocity prediction.

The stateful half of the reference's pose_prior node
(pose_prior_mult_node.cpp skeletonCallback, :505-921): feedback-delay moving
average, velocity-sigma-normalized track association with Hungarian gating,
per-person LM smoothing (prior.py) warm-started from the track, velocity ring
buffers and latency-compensating prediction, track lifecycle (spawn / decay /
merge) and the publish gate.

All state lives in a fixed-slot TrackerState pytree carried through
`step`, which is a single pure jittable function — the reference's
mutable globals + OpenMP critical sections disappear.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from smartedgesensor3dhumanpose_tpu import prior, skeleton
from smartedgesensor3dhumanpose_tpu.config import PriorConfig, TrackerConfig
from smartedgesensor3dhumanpose_tpu.ops import hungarian, linalg
from smartedgesensor3dhumanpose_tpu.types import Persons3D, TrackerState

_K = skeleton.NUM_FUSION_JOINTS
_COST_CLIP = 1.0e3


class TrackStepOutput(NamedTuple):
    fused: Persons3D        # persons3d_fused equivalent
    fused_pred: Persons3D   # persons3d_fused_pred equivalent
    pred_delta_t: jnp.ndarray  # [] predicted feedback latency
    # Track spawns lost because every fixed slot was alive (the reference
    # grows its track vector unboundedly, pose_prior_mult_node.cpp:570-580;
    # here the overflow is counted so the monitor can warn).
    n_dropped_spawns: jnp.ndarray  # [] int32


def _association_cost(
    state: TrackerState,
    persons: Persons3D,
    t: jnp.ndarray,
    cfg: TrackerConfig,
    prior_cfg: PriorConfig,
) -> jnp.ndarray:
    """Detection x track cost: mean joint distance normalized by per-joint
    velocity sigma x elapsed time (calc_normed_dist, :84-101)."""
    dtype = persons.xyz.dtype
    vel_sig = jnp.asarray(skeleton.FUSION_VEL_SIGMAS, dtype)
    delta_t = (t - state.t_prev)[None, :, None]  # [1, T, 1]
    prev = (
        state.estimate * state.height_prev[:, None, None]
        + state.root_prev[:, None, :]
    )  # [T, K, 3]
    diff = persons.xyz[:, None] - prev[None]  # [P, T, K, 3]
    dist = jnp.linalg.norm(diff, axis=-1) / (vel_sig[None, None] * delta_t)
    ok = (
        (persons.score > prior_cfg.min_score)[:, None, :]
        & state.est_exists[None]
    )  # [P, T, K]
    n = jnp.sum(ok, axis=-1)
    mean = jnp.sum(jnp.where(ok, dist, 0.0), axis=-1) / jnp.maximum(n, 1)
    cost = jnp.where(n > 0, mean, cfg.max_dist)
    cost = jnp.where(
        persons.valid[:, None] & state.alive[None], cost, cfg.max_dist
    )
    return cost


def smooth_cold(persons: Persons3D, prior_cfg: PriorConfig):
    """Frame-independent LM smoothing, cold-started from the measurements.

    The online path warm-starts the LM from the matched track's previous
    estimate (setInitialState, reference pose_prior_mult_node.cpp:483-503),
    which ties the optimization into the sequential per-frame scan. A
    converged LM reaches the same optimum from either start (the unary
    anchors dominate; verified to sub-0.1 mm in
    tests/test_pipeline.py::test_offline_cold_start_matches_online), so the
    offline throughput mode hoists this whole stage OUT of the scan and
    batches it over all frames — the dominant per-frame cost (4-6 LM
    iterations of 63x63 solves) runs as one big batch instead
    of 256 sequential launches.

    Returns the `precomputed` tuple accepted by `step`.
    """
    g_in = prior.build_graph_inputs(persons, prior_cfg)
    result = prior.optimize(g_in, g_in.meas, prior_cfg)
    xyz_out, cov_out = prior.denormalize(result, g_in, prior_cfg)
    xyz_out = jnp.where(g_in.active[..., None], xyz_out, 0.0)
    cov_out = jnp.where(g_in.active[..., None, None], cov_out, 0.0)
    return g_in, result, xyz_out, cov_out


def step(
    state: TrackerState,
    persons: Persons3D,
    t: jnp.ndarray,
    fb_delay: jnp.ndarray,
    prior_cfg: PriorConfig,
    cfg: TrackerConfig,
    precomputed=None,
) -> Tuple[TrackerState, TrackStepOutput]:
    """One tracker frame. `persons` is the fusion stage output; `t` the
    frame (pivot) timestamp; `fb_delay` [C] the per-camera measured feedback
    delays (-1 where unmeasured). `precomputed` optionally supplies the
    output of `smooth_cold` for this frame (offline mode); when None the LM
    runs here with the reference's track warm start."""
    dtype = persons.xyz.dtype
    t_slots = state.alive.shape[0]
    w = state.fb_delay_buffer.shape[0]
    t = jnp.asarray(t, dtype)

    # ---- feedback-delay moving average -> prediction horizon (:513-526)
    valid_delay = fb_delay > 0
    n_valid = jnp.sum(valid_delay)
    curr_avg = jnp.where(
        n_valid > 0,
        jnp.sum(jnp.where(valid_delay, fb_delay, 0.0)) / jnp.maximum(n_valid, 1),
        cfg.avg_delay,
    ).astype(dtype)
    fb_buffer = state.fb_delay_buffer.at[state.frame_nr % w].set(curr_avg)
    pred_delta_t = jnp.mean(fb_buffer)

    has_dets = jnp.any(persons.valid)

    # ---- association (:548-580)
    # Every indexed access below is a one-hot contraction / masked reduce,
    # not a gather or scatter: this step runs inside the sequential
    # per-frame scan. The one-hot selections are exact (at most one nonzero
    # per row; heinsum is Precision.HIGHEST).
    cost = _association_cost(state, persons, t, cfg, prior_cfg)
    assignment = hungarian.linear_sum_assignment(
        jnp.minimum(cost, _COST_CLIP)
    )  # [P] -> track slot or -1
    t_ids = jnp.arange(t_slots, dtype=jnp.int32)
    A = assignment[:, None] == t_ids[None, :]  # [P, T]; -1 matches nothing
    track_of = jnp.where(assignment >= 0, assignment, 0)
    assigned_cost = jnp.sum(jnp.where(A, cost, 0.0), axis=1)
    gated = (
        (assignment >= 0)
        & (assigned_cost <= cfg.dist_threshold)
        & jnp.any(A & state.alive[None, :], axis=1)
    )
    matched = persons.valid & gated

    # New tracks for unmatched valid persons, in person order (:570-580):
    # spawn p lands in the rank[p]-th dead slot.
    spawn = persons.valid & ~matched
    rank = jnp.cumsum(spawn.astype(jnp.int32)) - 1
    dead = ~state.alive
    free_pos = jnp.cumsum(dead.astype(jnp.int32)) - 1  # [T]
    S_free = (
        spawn[:, None] & dead[None, :] & (free_pos[None, :] == rank[:, None])
    )  # [P, T], at most one slot per person
    new_ok = jnp.any(S_free, axis=1)
    slot_new = jnp.where(
        new_ok,
        jnp.sum(jnp.where(S_free, t_ids[None, :], 0), axis=1, dtype=jnp.int32),
        t_slots,  # overflow -> dropped
    )
    n_dropped_spawns = (
        jnp.sum(spawn.astype(jnp.int32)) - jnp.sum(new_ok.astype(jnp.int32))
    )
    track_idx = jnp.where(matched, track_of, jnp.where(new_ok, slot_new, t_slots))
    has_track = matched | new_ok

    # Initialize spawned slots: S1[t, p] marks slot t receiving spawn p.
    new_ids = state.next_id + rank
    S1 = slot_new[None, :] == t_ids[:, None]  # [T, P]
    spawned = jnp.any(S1, axis=1)  # [T]
    alive = state.alive | spawned
    track_id = jnp.where(
        spawned,
        jnp.sum(jnp.where(S1, new_ids[None, :], 0), axis=1, dtype=jnp.int32),
        state.track_id,
    )
    est = jnp.where(spawned[:, None, None], 0.0, state.estimate)
    est_exists = state.est_exists & ~spawned[:, None]
    vel_buf = jnp.where(spawned[:, None, None, None], 0.0, state.vel_buffer)
    t_prev = jnp.where(spawned, t, state.t_prev)
    num_obs = jnp.where(spawned, 0, state.num_obs)
    height_prev = jnp.where(spawned, -1.0, state.height_prev)
    root_prev = jnp.where(spawned[:, None], 0.0, state.root_prev)
    next_id = (state.next_id + jnp.sum(new_ok.astype(jnp.int32))).astype(
        jnp.int32
    )

    # ---- per-person graph + LM smoothing (prior.py)
    if precomputed is None:
        g_in = prior.build_graph_inputs(persons, prior_cfg)
    else:
        g_in = precomputed[0]
    participates = has_track & (g_in.num_meas > 0)  # (:739-741)

    # Gather per-person previous track state (garbage where no track; masked)
    # via one-hot contractions over the track axis.
    safe_idx = jnp.where(has_track, track_idx, 0)
    G = safe_idx[:, None] == t_ids[None, :]  # [P, T] exactly one per row
    Gf = G.astype(dtype)
    prev_est_p = linalg.heinsum("pt,tkx->pkx", Gf, est)
    prev_exists_p = (
        jnp.any(G[:, :, None] & est_exists[None], axis=1)
        & has_track[:, None]
    )
    h_prev_p = jnp.sum(jnp.where(G, height_prev[None, :], 0.0), axis=1)
    root_prev_p = linalg.heinsum("pt,tx->px", Gf, root_prev)
    # height_prev < 0 -> initialize from current (:699-702).
    uninit = h_prev_p < 0
    h_prev_p = jnp.where(uninit, g_in.height, h_prev_p)
    root_prev_p = jnp.where(uninit[:, None], g_in.root_xyz, root_prev_p)

    use_velocity = g_in.active & prev_exists_p  # (:500)

    if precomputed is None:
        warm = jnp.where(use_velocity[..., None], prev_est_p, g_in.meas)
        result = prior.optimize(g_in, warm, prior_cfg)
        xyz_out, cov_out = prior.denormalize(result, g_in, prior_cfg)
        xyz_out = jnp.where(g_in.active[..., None], xyz_out, 0.0)
        cov_out = jnp.where(g_in.active[..., None, None], cov_out, 0.0)
    else:
        _, result, xyz_out, cov_out = precomputed

    # ---- velocity buffers + prediction (:818-831)
    dt_glob = jnp.maximum(t - state.t_prev_global, 1e-6)
    curr_world = result.x * g_in.height[:, None, None] + g_in.root_xyz[:, None]
    prev_world = prev_est_p * h_prev_p[:, None, None] + root_prev_p[:, None]
    vel = (curr_world - prev_world) / dt_glob  # [P, K, 3]

    vel_buf_p = linalg.heinsum("pt,tkwx->pkwx", Gf, vel_buf)  # [P, K, W, 3]
    # Joints dropped from the estimate reset their buffer (:490-493).
    removed = prev_exists_p & ~g_in.active
    vel_buf_p = jnp.where(removed[..., None, None], 0.0, vel_buf_p)
    slot_w = state.frame_nr % w
    vel_buf_p = vel_buf_p.at[:, :, slot_w].set(
        jnp.where(use_velocity[..., None], vel, vel_buf_p[:, :, slot_w])
    )
    mean_vel = jnp.mean(vel_buf_p, axis=2)  # [P, K, 3]
    pred_offset = jnp.where(
        use_velocity[..., None], mean_vel * pred_delta_t, 0.0
    )
    xyz_pred = xyz_out + pred_offset
    pred_noise = cfg.pred_noise_sigma**2 * jnp.eye(3, dtype=dtype)
    cov_pred = jnp.where(
        g_in.active[..., None, None], cov_out + pred_noise, 0.0
    )

    # ---- write back track state (:839-843): M2[t, p] marks slot t updated
    # from person p (each updated slot receives exactly one person).
    upd = participates & has_dets
    scatter_idx = jnp.where(upd, track_idx, t_slots)
    M2 = scatter_idx[None, :] == t_ids[:, None]  # [T, P]
    updated = jnp.any(M2, axis=1)  # [T]
    M2f = M2.astype(dtype)
    est = jnp.where(
        updated[:, None, None], linalg.heinsum("tp,pkx->tkx", M2f, result.x),
        est,
    )
    est_exists = jnp.where(
        updated[:, None],
        jnp.any(M2[:, :, None] & g_in.active[None], axis=1),
        est_exists,
    )
    vel_buf = jnp.where(
        updated[:, None, None, None],
        linalg.heinsum("tp,pkwx->tkwx", M2f, vel_buf_p),
        vel_buf,
    )
    t_prev = jnp.where(updated, t, t_prev)
    height_prev = jnp.where(
        updated, jnp.sum(jnp.where(M2, g_in.height[None, :], 0.0), axis=1),
        height_prev,
    )
    root_prev = jnp.where(
        updated[:, None], linalg.heinsum("tp,px->tx", M2f, g_in.root_xyz),
        root_prev,
    )
    num_obs = num_obs + updated.astype(jnp.int32)

    # Publish gate (:845-848): strictly more than min_num_obs observations
    # (count includes this frame's). G re-selects with the same safe index.
    obs_after = jnp.sum(
        jnp.where(G, num_obs[None, :], 0), axis=1, dtype=jnp.int32
    )
    publish = upd & (obs_after > cfg.min_num_obs)
    person_ids = jnp.where(
        has_track,
        jnp.sum(jnp.where(G, track_id[None, :], 0), axis=1, dtype=jnp.int32),
        -1,
    )

    fused = Persons3D(
        xyz=xyz_out,
        score=g_in.score_out,
        cov=cov_out,
        valid=publish,
        person_id=person_ids,
    )
    fused_pred = Persons3D(
        xyz=xyz_pred,
        score=g_in.score_out,
        cov=cov_pred,
        valid=publish,
        person_id=person_ids,
    )

    # ---- track decay (:191-211, called in both paths)
    alive = alive & ((t - t_prev) <= cfg.max_unobserved_time)

    # ---- merge overlapping tracks (:869-903): sequential pairwise
    # removal; skipped on detection-free frames (the reference early-outs
    # before the merge loop, :537-546).
    alive, fused, fused_pred = _merge_tracks(
        alive, track_id, est, est_exists, height_prev, root_prev,
        fused, fused_pred, has_dets, cfg,
    )

    new_state = TrackerState(
        alive=alive,
        track_id=track_id,
        estimate=est,
        est_exists=est_exists,
        vel_buffer=vel_buf,
        t_prev=t_prev,
        num_obs=num_obs,
        height_prev=height_prev,
        root_prev=root_prev,
        next_id=next_id,
        frame_nr=state.frame_nr + jnp.where(has_dets, 1, 0).astype(jnp.int32),
        fb_delay_buffer=fb_buffer,
        t_prev_global=t,
    )
    return new_state, TrackStepOutput(
        fused=fused,
        fused_pred=fused_pred,
        pred_delta_t=pred_delta_t,
        n_dropped_spawns=n_dropped_spawns,
    )


def _merge_tracks(
    alive, track_id, est, est_exists, height_prev, root_prev,
    fused: Persons3D, fused_pred: Persons3D, has_dets, cfg: TrackerConfig,
):
    """Remove tracks overlapping an earlier one (mean common-joint distance
    below threshold, calc_3d_dist :103-119); published persons of the removed
    track inherit the keeper's id (:892-898).

    Track positions are static during the sweep (unlike the fusion merge,
    nothing is averaged — only `alive` flips), so the reference's
    lexicographic pair loop (:869-903) collapses to the pure recurrence

        surv[j] = alive[j] and no i < j with close[i, j] and surv[i],
        keeper[j] = min{ i < j : close[i, j] and surv[i] }   (when not surv)

    — when the pair loop reaches (i, j), victim columns < j and keeper rows
    < i are settled, and a keeper is always a final survivor (a track dies
    only at its own column step, which precedes every step where it could
    act as keeper, and dead rows are excluded by the alive[i] test). The
    recurrence is solved by a monotone fixpoint instead of a T-1-step
    sequential sweep: each round settles at least the earliest unsettled
    slot (all its close predecessors are already settled), so the loop runs
    `longest close-chain + 1` rounds — one round for the overwhelmingly
    common no-close-pair frame, two for simple pair merges — of a few [T, T]
    vector ops each, replacing the former cond-guarded 63-step device loop
    that dominated the scaled tracker scan whenever any frame merged.
    """
    t_slots = alive.shape[0]
    if t_slots < 2:
        return alive, fused, fused_pred

    world = est * height_prev[:, None, None] + root_prev[:, None, :]
    idx = jnp.arange(t_slots)

    ok = est_exists[:, None] & est_exists[None, :]  # [T, T, K]
    d = jnp.linalg.norm(world[:, None] - world[None], axis=-1)
    n = jnp.sum(ok, axis=-1)
    mean_d = jnp.sum(jnp.where(ok, d, 0.0), axis=-1) / jnp.maximum(n, 1)
    close = (
        (idx[:, None] < idx[None, :])  # keeper i strictly before victim j
        & has_dets
        & (n > 0)
        & (mean_d < cfg.merge_dist_thresh)
        & alive[:, None]
        & alive[None, :]
    )  # [T(keeper), T(victim)]

    def unsettled(state):
        live, dead = state
        return jnp.any(alive & ~live & ~dead)

    def settle(state):
        live, dead = state
        # No close predecessor can still kill j -> j definitely survives.
        possible_killer = close & ~dead[:, None]
        live = live | (alive & ~jnp.any(possible_killer, axis=0))
        # A definitely-surviving close predecessor -> j definitely dies.
        dead = dead | jnp.any(close & live[:, None], axis=0)
        return live, dead

    no = jnp.zeros_like(alive)
    live, dead = jax.lax.while_loop(unsettled, settle, (no, no))

    # Keeper of each victim: FIRST surviving close predecessor (argmax picks
    # the lowest index — the pair loop's lexicographic order). Keeper ids are
    # survivor ids and victim ids are unique, so the per-victim id
    # reassignments (:892-898) are independent and apply in one batch; all
    # selections are one-hot contractions (no serialized gathers inside the
    # per-frame scan).
    kill = close & live[:, None]  # [T(keeper), T(victim)]
    keeper = jnp.argmax(kill, axis=0)  # [T] first True (0 where none; dead
    keeper_1h = idx[:, None] == keeper[None, :]  # gates below handle it)
    keeper_id = jnp.sum(
        jnp.where(keeper_1h, track_id[:, None], 0), axis=0, dtype=jnp.int32
    )  # [T(victim)]

    def reassign(pid):
        match = (pid[:, None] == track_id[None, :]) & dead[None, :]  # [P, T]
        new_id = jnp.sum(
            jnp.where(match, keeper_id[None, :], 0), axis=1, dtype=jnp.int32
        )
        return jnp.where(jnp.any(match, axis=1), new_id, pid)

    return (
        alive & ~dead,
        fused._replace(person_id=reassign(fused.person_id)),
        fused_pred._replace(person_id=reassign(fused_pred.person_id)),
    )
