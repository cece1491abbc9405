"""Batched RandomDistortion: policy sampling on host, compiled device apply.

The per-element RandomDistortion threads one image through a sampled
sequence of distortions (distortion_policy/random_distortion.py).  Here the
SAME stage sampler runs per batch element on the host (numpy rng, same
weights/conflict groups/retries), and the device applies each round per
distortion name: ONE compiled program (batched.py compiled dispatch,
param arrays as jit arguments) runs over the batch and a traced
where-select keeps non-members' pixels.  No per-draw retraces, and a
bounded compile set per (name, static-signature).

The geometric stage is batched too (batch_random_geometric_distort):
every sampled policy canonicalizes to a WarpPlan, all plans warp in one
device program on a shared max canvas, and the reference's corner-point
trim folds into per-sample active-content boxes.
"""
import zlib
from collections import defaultdict
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from numpy.random import Generator as RandomGenerator

from .batched import batch_distort_members
from .distortion_policy.random_distortion import (
    RandomDistortionStage,
    RandomDistortionStageConfig,
)

# Shape-changing params used to force per-sample applies; pixelation and
# zoom_in_blur now build their resize matrices from TRACED sizes
# (batched.py _apply_pixelation_traced / _apply_zoom_traced), so nothing
# needs the per-sample path anymore.
_PER_SAMPLE_ONLY = ()

# Config fields that select the traced program's STRUCTURE (channel subset,
# clip-vs-cycle, gate direction) rather than feeding it numerically; a
# batched apply can only share members whose static fields agree.
_STATIC_FIELDS = ('channels', 'oob_behavior', 'enable_threshold_lte')

# Ops whose former static fields now ride as TRACED arrays (batched.py
# compiled catalog): members group together regardless of channel subset
# or drawn color — one dispatch, one compiled program.
_NO_STATIC_GROUPING = frozenset({'histogram_equalization', 'fog'})


def _static_signature(name: str, config) -> tuple:
    if name in _NO_STATIC_GROUPING:
        return ()
    return tuple(
        (field, repr(getattr(config, field)))
        for field in _STATIC_FIELDS
        if hasattr(config, field)
    )


def batch_random_photometric_distort(
    images,
    level: int,
    rng: RandomGenerator,
    key=None,
    stage_config: Optional[RandomDistortionStageConfig] = None,
    use_mega: bool = True,
):
    """Apply a randomized photometric policy draw to each batch sample.

    ``images``: (N, H, W, 3) uint8 on device.  Returns the distorted batch.
    Policy weights / conflict groups / counts default to the photometric
    stage of random_distortion_factory.

    With ``use_mega`` (default) each round's draws covered by the
    one-program catalog (photometric_program.py) apply as a SINGLE jitted
    dispatch; only the excluded ops (blurs, scanned streaks, shape-changing
    statics) go through the per-name compiled dispatch.
    """
    if stage_config is None:
        from .distortion_policy.random_distortion import (
            random_distortion_factory,
        )
        stage_config = random_distortion_factory.create_photometric_stage_config()
    stage = RandomDistortionStage(stage_config)

    n, height, width = images.shape[:3]
    # Host-side seed schedule: the per-(round, name) keys derive from
    # traced uint32 seeds INSIDE the compiled programs, so no eager
    # fold_in dispatches.
    if key is None:
        base_seed = int(rng.integers(0, 2**31 - 1))
    else:
        base_seed = int(np.asarray(jax.random.key_data(key)).ravel()[-1])

    # Host: per-sample policy sequences + configs (same rng discipline as
    # the per-element path).
    sequences = []
    for _ in range(n):
        policies = ()
        if rng.random() <= stage_config.prob_enable:
            policies = stage.sample_distortion_policies(rng)
        seq = [
            (policy.name, policy.sample_config(level, (height, width), rng))
            for policy in policies
        ]
        sequences.append(seq)

    max_rounds = max((len(seq) for seq in sequences), default=0)
    out = jnp.asarray(images)
    for round_idx in range(max_rounds):
        name_to_members = defaultdict(list)
        for sample_idx, seq in enumerate(sequences):
            if round_idx < len(seq):
                name, config = seq[round_idx]
                name_to_members[name].append((sample_idx, config))

        if use_mega:
            from .photometric_program import (
                apply_mega_round,
                apply_mega_round_sub,
                build_round_params,
                mega_covers,
            )

            mega_members = {}
            for name, members in list(name_to_members.items()):
                covered = [
                    m for m in members if mega_covers(name, m[1])
                ]
                if not covered:
                    continue
                mega_members[name] = covered
                rest = [m for m in members if not mega_covers(name, m[1])]
                if rest:
                    name_to_members[name] = rest
                else:
                    del name_to_members[name]
            if mega_members:
                sel, params = build_round_params(n, mega_members)
                seed_r = np.uint32(
                    (base_seed + 0x9E3779B1 * (round_idx + 1)) & 0xFFFFFFFF
                )
                active = np.flatnonzero(sel >= 0)
                sub_bucket = next(
                    (b for b in (8, 16) if len(active) <= b < n), None
                )
                if sub_bucket is not None and n > 16:
                    # Sparse round (typically the 2nd policy draw): run
                    # the whole round on a gathered member sub-batch.
                    pad = sub_bucket - len(active)
                    idx = np.concatenate([
                        active, np.full(pad, active[0], dtype=np.int64),
                    ])
                    scat = np.concatenate([
                        active, np.full(pad, n, dtype=np.int64),
                    ])
                    out = apply_mega_round_sub(
                        out, jnp.asarray(idx), jnp.asarray(scat),
                        jnp.asarray(sel[idx]),
                        {k: v[idx] for k, v in params.items()}, seed_r,
                    )
                else:
                    out = apply_mega_round(out, sel, params, seed_r)

        for name, members in sorted(name_to_members.items()):
            seed = (
                base_seed + 0x85EBCA77 * (round_idx + 1)
                + zlib.crc32(name.encode())
            ) & 0xFFFFFFFF
            if name in _PER_SAMPLE_ONLY:
                groups = [[m] for m in members]
            else:
                by_sig = defaultdict(list)
                for member in members:
                    by_sig[_static_signature(name, member[1])].append(member)
                groups = [by_sig[sig] for sig in sorted(by_sig)]
            for group in groups:
                try:
                    out = batch_distort_members(name, group, out, seed)
                except AssertionError:
                    if len(group) == 1:
                        raise
                    # A shape-static param not covered by _STATIC_FIELDS
                    # differs within the group: apply member-by-member.
                    for member in group:
                        out = batch_distort_members(name, [member], out, seed)
    return out


def sample_geometric_plans(
    batch_size: int,
    shape,
    level: int,
    rng: RandomGenerator,
    stage_config: Optional[RandomDistortionStageConfig] = None,
):
    """One WarpPlan per sample from the geometric policy stage (exactly-one
    policy draw, maybe disabled -> nop plan), same rng discipline as the
    per-element RandomDistortion."""
    from .distortion.warp_plan import nop_plan

    if stage_config is None:
        from .distortion_policy.random_distortion import (
            random_distortion_factory,
        )
        stage_config = random_distortion_factory.create_geometric_stage_config()
    stage = RandomDistortionStage(stage_config)

    height, width = shape
    plans = []
    for _ in range(batch_size):
        plan = None
        if rng.random() <= stage_config.prob_enable:
            drawn = stage.sample_distortion_policies(rng)
            if drawn:
                policy = drawn[0]
                config = policy.sample_config(level, (height, width), rng)
                plan = policy.distortion.plan(config, (height, width), rng)
        plans.append(plan if plan is not None else nop_plan((height, width)))
    return plans


def batch_random_geometric_distort(
    images,
    level: int,
    rng: RandomGenerator,
    stage_config: Optional[RandomDistortionStageConfig] = None,
):
    """Apply a randomized geometric policy draw (exactly one, maybe
    disabled) to each batch sample, on a shared max-size canvas.

    Returns (warped (N, Hmax, Wmax, C) uint8, active (N, Hmax, Wmax) uint8,
    content_boxes).  Per-sample canvases pad to the batch max; the active
    mask marks each sample's valid warped region, and content_boxes are
    the per-sample active bounding boxes (the reference's corner-point
    trim, folded into the downstream crop).
    """
    from ..element import Box, Mask
    from .batched import batched_plan_warp
    from .distortion.warp_plan import warp_active_mask

    n, height, width = images.shape[:3]
    plans = sample_geometric_plans(
        n, (height, width), level, rng, stage_config=stage_config
    )

    warped, shapes, _ = batched_plan_warp(plans, images)

    h_max = max(s[0] for s in shapes)
    w_max = max(s[1] for s in shapes)
    active = np.zeros((n, h_max, w_max), dtype=np.uint8)
    content_boxes = []
    for idx, plan in enumerate(plans):
        h, w = shapes[idx]
        active[idx, :h, :w] = warp_active_mask(plan).mat
        try:
            content_boxes.append(Mask(mat=active[idx]).to_external_box())
        except RuntimeError:
            content_boxes.append(Box(0, h - 1, 0, w - 1))
    return warped, active, content_boxes


def batch_random_distort(
    images,
    level: int,
    rng: RandomGenerator,
    key=None,
    factory_config=None,
):
    """Full randomized distortion for a batch: the photometric stage, then
    the geometric stage, with the trim folded into per-sample content
    boxes — the batched twin of RandomDistortion.distort.

    Returns (images (N, Hmax, Wmax, C) uint8, active (N, Hmax, Wmax) uint8,
    content_boxes).
    """
    from .distortion_policy.random_distortion import random_distortion_factory

    photometric_cfg = random_distortion_factory.create_photometric_stage_config(
        factory_config
    )
    geometric_cfg = random_distortion_factory.create_geometric_stage_config(
        factory_config
    )
    out = batch_random_photometric_distort(
        images, level, rng, key=key, stage_config=photometric_cfg
    )
    return batch_random_geometric_distort(
        out, level, rng, stage_config=geometric_cfg
    )
