"""Steady-state warmup: compile the full randomized-distortion program set
up front so timed/production batches never trace or compile.

Randomized policy draws walk a compiled-program set that would otherwise
TRICKLE in across batches: each fresh XLA compile costs seconds, and a
benchmark window that compiles measures the compiler instead of the
pipeline.  The reference has no such phase: each
sample is an eager cv2 call chain (vkit/mechanism/distortion_policy/
random_distortion.py:219-392).  On XLA the correct design is to make the
program set (a) FINITE — every compiled-signature static quantized to a
sparse ladder, nothing keyed on a drawn value (fog colors and channel
subsets now ride as traced arrays, batched.py) — and (b) WARM — this
module compiles the whole set once at startup; the persistent compilation
cache (utility.enable_compilation_cache) makes that a one-time cost per
machine, not per process.

Two layers:
  warmup_photometric  — enumerates every non-mega catalog op x dispatch
                        mode, plus the mega-round full/sub programs.
  warmup_geometric    — replays fixed-seed policy draws through
                        batched_plan_warp AND drives the tap-ladder /
                        reject paths with synthetic plans.
warmup_random_distortion runs both for one production (batch, shape)
config.  All warmups are shape-keyed and idempotent (a process-local set
skips repeats).
"""
import logging
from typing import Optional, Tuple

import numpy as np

logger = logging.getLogger(__name__)

_DONE = set()


def _mark(key) -> bool:
    if key in _DONE:
        return True
    _DONE.add(key)
    return False


# ---------------------------------------------------------------------------
# Photometric: non-mega catalog ops x modes + mega round programs.
# ---------------------------------------------------------------------------

# Non-mega ops reachable from the randomized photometric stage at default
# knobs (photometric_program.py module docstring).  Blurs are mega-covered
# at default knob ranges (kernel <= 7) and excluded here; custom-knob blur
# rungs compile on first use only.
_NON_MEGA_NAMES = (
    'histogram_equalization',
    'jpeg_quality',
    'fog',
    'poisson_noise',
    'pixelation',
    'zoom_in_blur',
    'glass_blur',
    'rectangle_streak',
    'ellipse_streak',
)


def _stage_policies():
    from .distortion_policy.random_distortion import (
        random_distortion_factory,
    )

    stage_cfg = random_distortion_factory.create_photometric_stage_config()
    seen = {}
    for policy in stage_cfg.distortion_policies:
        seen[policy.name] = policy
    return list(seen.values())


def _policy_for(name: str):
    for policy in _stage_policies():
        if policy.name == name:
            return policy
    return None


def warmup_photometric(
    batch: int,
    shape: Tuple[int, int],
    level: int = 5,
) -> int:
    """Compile every (non-mega op, dispatch mode) program + the mega-round
    programs for one (batch, H, W) config.  Returns programs touched."""
    import jax
    import jax.numpy as jnp

    from .batched_random import batch_random_photometric_distort
    from .batched import batch_distort_members
    from .photometric_program import (
        apply_mega_round,
        apply_mega_round_sub,
        build_round_params,
        mega_covers,
    )

    key = ('photo', batch, tuple(shape), level)
    if _mark(key):
        return 0

    h, w = shape
    images = jnp.asarray(
        np.random.default_rng(0).integers(
            0, 256, (batch, h, w, 3), dtype=np.uint8
        )
    )
    rng = np.random.default_rng(12345)
    touched = 0

    # Mega round: the full-batch program + both sub buckets.
    mega_policy = next(
        p for p in _stage_policies() if mega_covers(p.name)
    )
    cfg = mega_policy.sample_config(level, (h, w), rng)
    members = [(i, cfg) for i in range(batch)]
    sel, params = build_round_params(batch, {mega_policy.name: members})
    apply_mega_round(images, sel, params, np.uint32(1))
    touched += 1
    for bucket in (8, 16):
        if bucket >= batch:
            continue
        idx = np.arange(bucket, dtype=np.int64)
        scat = idx.copy()
        sel_b, params_b = build_round_params(
            batch, {mega_policy.name: members[:bucket]}
        )
        apply_mega_round_sub(
            images, jnp.asarray(idx), jnp.asarray(scat),
            jnp.asarray(sel_b[idx]),
            {k: v[idx] for k, v in params_b.items()}, np.uint32(1),
        )
        touched += 1

    # Non-mega ops: 'sub' (the overwhelmingly common mode for rare draws)
    # and 'masked' (9..n-1 members).  'full' requires every sample to
    # draw the same op in one round — unreachable in practice at n >= 16;
    # it would compile once if it ever fired.
    for name in _NON_MEGA_NAMES:
        policy = _policy_for(name)
        if policy is None:
            continue
        cfg = policy.sample_config(level, (h, w), rng)
        out = batch_distort_members(name, [(0, cfg)], images, 7)
        touched += 1
        if batch > 9:
            members = [(i, cfg) for i in range(9)]
            out = batch_distort_members(name, members, images, 7)
            touched += 1
        # Force execution so compiles land before timing starts.
        jax.block_until_ready(out)

    # Replay: fixed-seed full photometric rounds catch any combination
    # plumbing not covered above (round chaining, seed schedules).
    for _ in range(2):
        out = batch_random_photometric_distort(
            images, level, rng, key=jax.random.PRNGKey(3)
        )
    float(jnp.asarray(out[:, ::64, ::64, 0]).mean())
    return touched


# ---------------------------------------------------------------------------
# Geometric: tap-ladder rungs, bucket sizes, reject paths.
# ---------------------------------------------------------------------------


def warmup_geometric(
    batch: int,
    src_shape: Tuple[int, int],
    out_shape: Optional[Tuple[int, int]] = None,
    channels: int = 3,
    level: int = 5,
    replay_batches: int = 4,
) -> int:
    """Compile the warp program set for one (batch, src, out, C) config.

    Fixed-seed policy replay covers the production mix (affine direct,
    mixed affine+banded with every common bucket, taps rungs); synthetic
    extreme plans force the reject tail (half-res prefilter + gather
    fallback) that random draws may not hit for many batches.
    """
    import jax.numpy as jnp

    from .batched import batched_plan_warp
    from .batched_random import sample_geometric_plans
    from .distortion.warp_plan import (
        matrix_plan,
        nop_plan,
        rescale_plan_to,
    )

    out_shape = tuple(out_shape or src_shape)
    key = ('geo', batch, tuple(src_shape), out_shape, channels, level)
    if _mark(key):
        return 0

    h, w = src_shape
    # Build the stack the way production callers do — a uint8 image batch
    # cast to f32 CONCATENATED with f32 label channels — so the eager
    # convert/concatenate programs for this shape compile here too.
    rng0 = np.random.default_rng(1)
    img_u8 = jnp.asarray(
        rng0.integers(0, 256, (batch, h, w, 3), dtype=np.uint8)
    )
    extra = jnp.asarray(
        np.ones((batch, h, w, max(channels - 3, 1)), dtype=np.float32)
    )
    if channels > 3:
        stack = jnp.concatenate([img_u8.astype(jnp.float32), extra],
                                axis=-1)
    else:
        stack = img_u8.astype(jnp.float32)[..., :channels]
    rng = np.random.default_rng(424242)
    touched = 0

    for _ in range(replay_batches):
        raw = sample_geometric_plans(batch, (h, w), level, rng)
        plans = [rescale_plan_to(p, out_shape) for p in raw]
        out = batched_plan_warp(plans, stack, mode='auto')[0]
        touched += 1
    float(jnp.asarray(out[:, ::64, ::64, 0]).mean())

    # All-affine batch (rotations cover the quadrant-reduced program).
    def rot(theta):
        c, s = np.cos(theta), np.sin(theta)
        cy, cx = (h - 1) / 2.0, (w - 1) / 2.0
        t = np.asarray([
            [c, -s, cx - c * cx + s * cy],
            [s, c, cy - s * cx - c * cy],
        ])
        return matrix_plan(t, (h, w), (h, w))

    plans = [
        rescale_plan_to(rot(i * 2 * np.pi / batch), out_shape)
        for i in range(batch)
    ]
    out = batched_plan_warp(plans, stack, mode='auto')[0]
    touched += 1

    # Reject tail: extreme zoom-out plans (source span per output block
    # beyond the tap ladder) at both reject buckets, mixed with nops so
    # the accepted-group scatter paths compile too.
    for n_rej in (1, 9):
        if n_rej >= batch:
            break
        zoom = np.asarray([[12.0, 0.0, 0.0], [0.0, 12.0, 0.0]])
        plans = [
            rescale_plan_to(
                matrix_plan(zoom, (h, w), (h, w)) if i < n_rej
                else nop_plan((h, w)),
                out_shape,
            )
            for i in range(batch)
        ]
        out = batched_plan_warp(plans, stack, mode='auto')[0]
        touched += 1
    float(jnp.asarray(out[:, ::64, ::64, 0]).mean())
    return touched


def warmup_random_distortion(
    batch: int,
    src_shape: Tuple[int, int],
    out_shape: Optional[Tuple[int, int]] = None,
    warp_channels: int = 3,
    level: int = 5,
) -> int:
    """Full warmup for one production batch config; returns programs
    touched (0 when this config already warmed in-process)."""
    from ..utility import enable_compilation_cache, tune_host_allocator

    enable_compilation_cache()
    tune_host_allocator()
    touched = warmup_photometric(batch, src_shape, level=level)
    touched += warmup_geometric(
        batch, src_shape, out_shape, channels=warp_channels, level=level
    )
    if touched:
        logger.info('steady-state warmup: %d program groups touched',
                    touched)
    return touched
