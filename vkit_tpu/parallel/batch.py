"""Batched device synthesis: the distortion pipeline as ONE jitted program.

The reference applies distortions one image at a time on the CPU
(vkit/mechanism/distortion/interface.py:214-310, one cv2 call per op).  The
device path instead samples per-image parameters on the host (cheap,
numpy) and runs the whole batch through a single traced program: geometric
warp (two-pass shifts+matmuls, ops/warp_mxu.py), photometric chain
(contrast/brightness/noise fused elementwise), the bit-exact JPEG roundtrip
(ops/jpeg_exact.py, per-sample quant tables), and the final resize
(tap-weight matmuls).  Static shapes, no per-sample Python, everything
fuses under jit.
"""
import functools
import math
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec
from numpy.random import Generator as RandomGenerator

from ..ops.common import round_u8, to_f32
from ..ops.effect import (
    _CHROMA_QTABLE,
    _LUMA_QTABLE,
    _pad_to_multiple,
    _quality_scaled_table,
    _quantize_channel,
)
from ..ops.resize import Interpolation, resize
from ..ops.warp_mxu import (
    AffineWarpPlan,
    AffineWarpStatics,
    apply_affine_warp,
    plan_affine_warp,
)


class SynthesisParams(NamedTuple):
    """Struct-of-arrays, one row per sample; a valid jit input pytree."""
    # Host-planned two-pass warp (ops/warp_mxu.py).
    warp_plan: AffineWarpPlan
    # Forward 3x3 mats kept for label co-transform (transform_label_points).
    trans_mats: jnp.ndarray      # (N, 3, 3) f32
    contrasts: jnp.ndarray       # (N,) f32
    brightnesses: jnp.ndarray    # (N,) f32
    noise_stds: jnp.ndarray      # (N,) f32
    luma_qtables: jnp.ndarray    # (N, 8, 8) f32
    chroma_qtables: jnp.ndarray  # (N, 8, 8) f32
    jpeg_enables: jnp.ndarray    # (N,) f32 in {0, 1}


def sample_synthesis_params(
    rng: RandomGenerator,
    batch_size: int,
    height: int,
    width: int,
    level: int = 5,
) -> Tuple[SynthesisParams, AffineWarpStatics]:
    """Host-side parameter sampling (numpy rng, like the policy layer).

    Ranges follow the distortion_policy defaults at the given level
    (vkit/mechanism/distortion_policy/photometric/color.py,
    geometric/affine.py): rotation up to ~30 deg, shear up to ~15 deg,
    scale 0.8-1.2, brightness +-50, contrast 0.6-1.4, noise std up to 20,
    JPEG quality 95 down to 30.
    """
    ratio = level / 10.0
    n = batch_size
    cy, cx = (height - 1) / 2.0, (width - 1) / 2.0

    angles = rng.uniform(-30.0 * ratio, 30.0 * ratio, size=n)
    shears = rng.uniform(-15.0 * ratio, 15.0 * ratio, size=n)
    scales = rng.uniform(1.0 - 0.2 * ratio, 1.0 + 0.2 * ratio, size=n)

    mats = np.zeros((n, 3, 3), dtype=np.float32)
    for idx in range(n):
        rad = math.radians(angles[idx])
        sh = math.tan(math.radians(shears[idx]))
        sc = scales[idx]
        cos_v, sin_v = math.cos(rad) * sc, math.sin(rad) * sc
        # rotate(angle) . shear_x(sh), about the image center.
        a, b = cos_v + sin_v * 0.0, -sin_v
        rot = np.array([[cos_v, -sin_v], [sin_v, cos_v]])
        shear = np.array([[1.0, sh], [0.0, 1.0]])
        lin = rot @ shear
        mats[idx, :2, :2] = lin
        mats[idx, 0, 2] = cx - lin[0, 0] * cx - lin[0, 1] * cy
        mats[idx, 1, 2] = cy - lin[1, 0] * cx - lin[1, 1] * cy
        mats[idx, 2, 2] = 1.0

    contrasts = rng.uniform(1.0 - 0.4 * ratio, 1.0 + 0.4 * ratio, size=n)
    brightnesses = rng.uniform(-50.0 * ratio, 50.0 * ratio, size=n)
    noise_stds = rng.uniform(0.0, 20.0 * ratio, size=n)

    qualities = rng.integers(max(30, 95 - round(65 * ratio)), 96, size=n)
    luma = np.stack([
        _quality_scaled_table(_LUMA_QTABLE, q) for q in qualities
    ]).astype(np.int32)
    chroma = np.stack([
        _quality_scaled_table(_CHROMA_QTABLE, q) for q in qualities
    ]).astype(np.int32)
    jpeg_enables = (rng.random(n) < 0.7).astype(np.float32)

    warp_plan, warp_statics = plan_affine_warp(mats, (height, width))

    return SynthesisParams(
        warp_plan=warp_plan,
        trans_mats=jnp.asarray(mats),
        contrasts=jnp.asarray(contrasts, dtype=jnp.float32),
        brightnesses=jnp.asarray(brightnesses, dtype=jnp.float32),
        noise_stds=jnp.asarray(noise_stds, dtype=jnp.float32),
        luma_qtables=jnp.asarray(luma),
        chroma_qtables=jnp.asarray(chroma),
        jpeg_enables=jnp.asarray(jpeg_enables),
    ), warp_statics


@functools.partial(jax.jit, static_argnames=('warp_statics', 'out_shape'))
def synthesize_batch(
    images,
    params: SynthesisParams,
    key,
    warp_statics: AffineWarpStatics,
    out_shape: Optional[Tuple[int, int]] = None,
):
    """The full batched distortion program: warp + photometric + JPEG + resize.

    ``images``: (N, H, W, 3) uint8.  Returns (N, out_h, out_w, 3) uint8.
    """
    n, height, width = images.shape[:3]

    # Geometric: the two-pass shifts+matmuls warp.
    x = apply_affine_warp(to_f32(images), params.warp_plan, warp_statics)

    # Photometric: contrast & brightness (fused elementwise).
    c = params.contrasts[:, None, None, None]
    b = params.brightnesses[:, None, None, None]
    x = x * c + b

    # Gaussian noise, per-sample std.
    noise = jax.random.normal(key, x.shape, dtype=jnp.float32)
    x = x + noise * params.noise_stds[:, None, None, None]
    x = jnp.clip(x, 0.0, 255.0)

    # JPEG roundtrip, per-sample quality tables, gated per sample —
    # the BIT-EXACT integer libjpeg pipeline (the reference's jpeg op
    # consumes a uint8 image, so round first; ops/jpeg_exact.py).
    from ..ops.jpeg_exact import jpeg_roundtrip_exact_jnp

    x_u8 = round_u8(jnp.clip(x, 0.0, 255.0))
    x_jpeg = jax.vmap(jpeg_roundtrip_exact_jnp)(
        x_u8, params.luma_qtables, params.chroma_qtables
    )
    gate = params.jpeg_enables[:, None, None, None] > 0.5
    x = jnp.where(gate, x_jpeg, x_u8).astype(jnp.float32)

    if out_shape is not None and out_shape != (height, width):
        x = jax.vmap(lambda im: resize(im, out_shape, Interpolation.LINEAR))(x)

    return round_u8(x)


def synthesize_with_labels(
    images,
    labels,
    params: SynthesisParams,
    key,
    warp_statics: AffineWarpStatics,
    out_shape: Optional[Tuple[int, int]] = None,
):
    """``synthesize_batch`` plus the label rasters (N, H, W, L) f32 warped
    by the identical per-sample plan.  Returns (images u8, labels f32)."""
    out = synthesize_batch(
        images, params, key, warp_statics=warp_statics, out_shape=out_shape
    )
    return out, apply_affine_warp(labels, params.warp_plan, warp_statics)


def shard_synthesis(
    mesh: Mesh,
    params: SynthesisParams,
    warp_statics: AffineWarpStatics,
    out_shape: Optional[Tuple[int, int]] = None,
    axis: str = 'dp',
):
    """``synthesize_with_labels`` as one SPMD program over ``mesh``: the
    images, labels and every params leaf are sharded on their batch axis
    over ``axis``, the key is replicated, and each device generates its
    own shard.  Shard k equals ``synthesize_with_labels`` run on shard k's
    inputs alone (the noise draw depends only on the key and the shard's
    shape).  ``params`` gives the pytree structure."""
    spec = PartitionSpec(axis)
    return jax.shard_map(
        functools.partial(
            synthesize_with_labels,
            warp_statics=warp_statics, out_shape=out_shape,
        ),
        mesh=mesh,
        in_specs=(spec, spec, jax.tree_util.tree_map(lambda _: spec, params),
                  PartitionSpec()),
        out_specs=(spec, spec),
        check_vma=False,
    )


def transform_label_points(
    params: SynthesisParams,
    np_points: np.ndarray,
    out_scale: Tuple[float, float] = (1.0, 1.0),
) -> np.ndarray:
    """Co-transform label points (host-side) through the batch geometry.

    ``np_points``: (N, P, 2) xy per sample.  Applies each sample's forward
    homography (the same matrix the warp inverts), then the final resize
    scale; mirrors the reference's point path in
    vkit/mechanism/distortion/geometric/affine.py:46-64.
    """
    mats = np.asarray(params.trans_mats, dtype=np.float64)
    np_points = np.asarray(np_points, dtype=np.float64)
    homo = np.concatenate(
        [np_points, np.ones_like(np_points[..., :1])], axis=-1
    )
    out = np.einsum('npk,njk->npj', homo, mats)
    denom = out[..., 2:3]
    denom = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    xy = out[..., :2] / denom
    xy[..., 0] *= out_scale[1]
    xy[..., 1] *= out_scale[0]
    return xy
