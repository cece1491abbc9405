"""Batched affine warp as shifts + matmuls: the two-pass remap.

The backward affine warp decomposes into the classic two-pass form
(vertical then horizontal resampling; Catmull-Smith):

  out[y, x] = img[sy(x, y), sx(x, y)],   [sx, sy] affine in (x, y)

  pass V:  tmp[y, u] = img[g(y, u), u]       g affine:  g = beta*y + (alpha*u + gamma)
  pass H:  out[y, x] = tmp[y, a*x + (b*y + c)]

Each pass is a 1D linear resample along one axis whose sampling position is
``slope * j + offset_line``: the integer part of the per-line offset becomes
a per-row shift (``row_shift``), and the slope part becomes a 3-tap one-hot
matmul with per-pixel blend weights.  Within each pass the interpolation is
exact linear; the two-pass composition filters with a sheared
(parallelogram) footprint instead of the axis-aligned bilinear square —
visually equivalent, not bit-equal to cv2.remap.  The per-element host path
(ops/warp.py remap_np) keeps exact cv2 semantics; this path is the batched
throughput engine (capability parity: cv2.warpAffine at
vkit/mechanism/distortion/geometric/affine.py:40).
"""
import math
from functools import partial
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

# Read window the planners budget past each per-line start: a padded
# shift must see ``m_shift <= _ROLL_WINDOW - 128`` lanes from its start.
_ROLL_WINDOW = 1024


def row_shift(x, starts, out_width: int, border_value: float = 0.0):
    """``out[n, l, ..., j] = x[n, l, ..., starts[n, l] + j]``.

    ``x``: (N, L, W) or (N, L, C, W); ``starts``: (N, L) int, any value.
    Positions outside ``[0, W)`` read ``border_value``.  Each output row
    reads one contiguous source run, so the gather is coalesced.
    """
    width = x.shape[-1]
    idx = (
        jnp.asarray(starts, jnp.int32)[:, :, None]
        + jnp.arange(out_width, dtype=jnp.int32)
    )
    idx = idx.reshape(idx.shape[:2] + (1,) * (x.ndim - 3) + (out_width,))
    vals = jnp.take_along_axis(x, jnp.clip(idx, 0, width - 1), axis=-1)
    inside = (idx >= 0) & (idx < width)
    return jnp.where(inside, vals, jnp.asarray(border_value, x.dtype))


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


class LineResamplePlan(NamedTuple):
    """Device arrays for one resample pass (host-planned)."""
    i0: jnp.ndarray       # (N, J) int32: floor(slope * j) - i0_min
    frac_j: jnp.ndarray   # (N, J) f32: frac(slope * j)
    starts: jnp.ndarray   # (N, L) int32: per-line shift into the padded axis
    phi: jnp.ndarray      # (N, L) f32: fractional per-line offset


class LineResampleStatics(NamedTuple):
    pad_lo: int
    m_padded: int
    m_shift: int
    out_len: int


def plan_line_resample(
    slopes: np.ndarray,
    offsets: np.ndarray,
    in_len: int,
    out_len: int,
    canonical: bool = False,
) -> Tuple[LineResamplePlan, LineResampleStatics]:
    """Host-side planning: all integer index math in float64 numpy.

    ``slopes``: (N,); ``offsets``: (N, L) — sampling position for line l,
    output index j is ``slopes[n] * j + offsets[n, l]`` in source coords.

    ``canonical``: round the statics (which select the compiled program)
    up to a sparse ladder sized for the whole quadrant-reduced affine
    family, so every randomized batch of a given (in_len, out_len) config
    reuses ONE compilation instead of compiling per draw.  Costs some
    wasted tap-matmul width; wins whenever params are random per batch.
    """
    slopes = np.asarray(slopes, dtype=np.float64)
    offsets = np.asarray(offsets, dtype=np.float64)
    n = slopes.shape[0]

    j = np.arange(out_len, dtype=np.float64)
    pos_j = slopes[:, None] * j[None, :]
    i0_abs = np.floor(pos_j).astype(np.int64)          # (N, J)
    frac_j = (pos_j - i0_abs).astype(np.float32)
    # Per-SAMPLE i0 origin: mixed slope signs across a batch must not add
    # their index spans (a +1 and a -1 slope would double m_shift).
    i0_min = i0_abs.min(axis=1)                        # (N,)
    m_shift = int((i0_abs.max(axis=1) - i0_min).max()) + 3

    k = np.floor(offsets).astype(np.int64)             # (N, L)
    phi = (offsets - k).astype(np.float32)

    starts_src = k + i0_min[:, None]                   # absolute src index of tap m=0

    def _statics_for(quant: int, shift_quant: int):
        ms = _round_up(m_shift, shift_quant)
        lo = _round_up(max(0, -int(starts_src.min())), quant)
        # The kernel reads a full 1024-lane roll window from each start.
        mp = _round_up(
            max(in_len + lo, int(starts_src.max()) + lo + _ROLL_WINDOW),
            quant,
        )
        return lo, mp, ms

    def _feasible(lo: int, mp: int, ms: int) -> bool:
        # Feasible iff SOME shift kernel covers the window: the padded
        # roll-window path, or the borderless 2048-lane slab path (the
        # same window_ok test apply_line_resample uses).  Strong rotations
        # after quadrant reduction need m_shift up to ~|tan 45| * J + 3.
        rel_min = -lo
        rel_max = mp - _ROLL_WINDOW - lo
        slab_ok = (
            in_len + ms <= 2048
            and rel_min >= -(2048 - in_len - ms)
            and rel_max <= 2048 - ms
        )
        return slab_ok or ms <= _ROLL_WINDOW - 128

    # Bucket statics (multiples of 128) so minor param changes don't
    # recompile.  Canonical mode derives statics from the SHAPE alone
    # where possible: m_shift rounds to a 512 ladder, and pad_lo/m_padded
    # sit at the slab kernel's feasibility bounds (maximal, fixed given
    # m_shift — the slab path never materializes the padding, so the
    # slack is free).  Randomized batches of one (in_len, out_len) config
    # then share ONE compiled program per m_shift rung instead of
    # compiling per draw (measured: ~35 distinct programs per bench
    # config without this).
    pad_nat = max(0, -int(starts_src.min()))
    smax_nat = int(starts_src.max())
    canonical_ok = False
    if canonical:
        ms = max(_round_up(m_shift, 512), 512)
        if in_len + ms <= 2048:
            lo = (2048 - in_len - ms) // 128 * 128      # slab rel_min bound
            mp_nat = max(in_len + lo, smax_nat + lo + _ROLL_WINDOW)
            mp = (2048 - ms + _ROLL_WINDOW + lo) // 128 * 128  # rel_max bound
            if lo >= pad_nat and mp >= mp_nat:
                pad_lo, m_padded, m_shift = lo, mp, ms
                canonical_ok = _feasible(lo, mp, ms)
    if not canonical_ok:
        pad_lo, m_padded, m_shift = _statics_for(128, 1)
    starts = (starts_src + pad_lo).astype(np.int32)

    assert _feasible(pad_lo, m_padded, m_shift), (
        f'resample span {m_shift} (in_len {in_len}) exceeds both shift '
        'kernels; split the axis or reduce the scale factor'
    )

    # Plain numpy in the plan: as jit-call arguments they transfer in one
    # batch instead of one eager upload per array.
    plan = LineResamplePlan(
        i0=(i0_abs - i0_min[:, None]).astype(np.int32),
        frac_j=frac_j,
        starts=starts,
        phi=phi,
    )
    statics = LineResampleStatics(
        pad_lo=pad_lo, m_padded=m_padded, m_shift=m_shift, out_len=out_len
    )
    return plan, statics


def apply_line_resample(
    x_slab,
    plan: LineResamplePlan,
    statics: LineResampleStatics,
    border_value: float = 0.0,
):
    """Resample (N, L, C, M_in) along the last axis -> (N, L, C, out_len).

    Slab layout: lines lead, channels ride along (one shift per line moves
    every channel).  Jittable (statics static).
    """
    n, l, c, m_in = x_slab.shape
    shifted = row_shift(
        x_slab, plan.starts - statics.pad_lo, statics.m_shift,
        border_value=border_value,
    )                                                     # (N, L, C, m_shift)

    # One-hot 3-tap gather matrices, built on device from (N, J) indices.
    jn = statics.out_len
    iota_m = jnp.arange(statics.m_shift, dtype=jnp.int32)[None, :, None]
    taps = (
        plan.i0[:, None, :, None]
        + jnp.arange(3, dtype=jnp.int32)[None, None, None, :]
    )                                                   # (N, 1, J, 3)
    taps = taps.transpose(0, 1, 3, 2).reshape(n, 1, 3 * jn)
    g = (iota_m == taps).astype(x_slab.dtype)           # (N, m_shift, 3J)

    a = jnp.einsum(
        'nlcm,nmq->nlcq', shifted, g, preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    )
    a = a.reshape(n, l, c, 3, jn)

    u = plan.frac_j[:, None, :] + plan.phi[:, :, None]  # (N, L, J) in [0, 2)
    w0 = jnp.maximum(1.0 - u, 0.0)
    w2 = jnp.maximum(u - 1.0, 0.0)
    w1 = 1.0 - w0 - w2
    w = jnp.stack([w0, w1, w2], axis=2)[:, :, None]     # (N, L, 1, 3, J)
    return (a * w).sum(axis=3)                          # (N, L, C, J)


class AffineWarpPlan(NamedTuple):
    pass_v: LineResamplePlan
    pass_h: LineResamplePlan


class AffineWarpStatics(NamedTuple):
    statics_v: LineResampleStatics
    statics_h: LineResampleStatics
    src_shape: Tuple[int, int]
    dst_shape: Tuple[int, int]


def plan_affine_warp(
    trans_mats: np.ndarray,
    src_shape: Tuple[int, int],
    dst_shape: Optional[Tuple[int, int]] = None,
    canonical: bool = False,
) -> Tuple[AffineWarpPlan, AffineWarpStatics]:
    """Plan the two passes from host-known FORWARD 2x3/3x3 matrices."""
    trans_mats = np.asarray(trans_mats, dtype=np.float64)
    if trans_mats.shape[1:] == (2, 3):
        bottom = np.tile([[0.0, 0.0, 1.0]], (len(trans_mats), 1, 1))
        trans_mats = np.concatenate([trans_mats, bottom], axis=1)
    assert trans_mats.shape[1:] == (3, 3)
    persp = np.abs(trans_mats[:, 2, :2]).max()
    assert persp < 1e-9, 'two-pass warp supports affine matrices only'

    h_in, w_in = src_shape
    if dst_shape is None:
        dst_shape = src_shape
    h_out, w_out = dst_shape

    inv = np.linalg.inv(trans_mats)
    a, b, c = inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2]
    d, e, f = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    assert np.abs(a).min() > 0.15, (
        'warp too close to a 90-degree rotation for this decomposition; '
        'pre-rotate by a multiple of 90 degrees (transpose/flip) first'
    )

    # Pass V: for input column u, sample source rows at
    #   g(y, u) = beta * y + (alpha * u + gamma).
    alpha = d / a
    beta = e - d * b / a
    gamma = f - d * c / a
    u = np.arange(w_in, dtype=np.float64)
    offsets_v = alpha[:, None] * u[None, :] + gamma[:, None]   # (N, W_in)
    plan_v, statics_v = plan_line_resample(
        beta, offsets_v, h_in, h_out, canonical=canonical
    )

    # Pass H: for output row y, sample tmp columns at a * x + (b * y + c).
    y = np.arange(h_out, dtype=np.float64)
    offsets_h = b[:, None] * y[None, :] + c[:, None]           # (N, H_out)
    plan_h, statics_h = plan_line_resample(
        a, offsets_h, w_in, w_out, canonical=canonical
    )

    return (
        AffineWarpPlan(pass_v=plan_v, pass_h=plan_h),
        AffineWarpStatics(
            statics_v=statics_v, statics_h=statics_h,
            src_shape=(h_in, w_in), dst_shape=(h_out, w_out),
        ),
    )


def apply_affine_warp(
    images,
    plan: AffineWarpPlan,
    statics: AffineWarpStatics,
    border_value: float = 0.0,
):
    """Warp (N, H, W, C) f32/uint8 by the planned decomposition (jittable)."""
    had_c = images.ndim == 4
    if not had_c:
        images = images[..., None]
    orig_dtype = images.dtype
    x = images.astype(jnp.float32)

    # Pass V: lines = input columns; resample along rows (slab layout).
    x_v = x.transpose(0, 2, 3, 1)                          # (N, W_in, C, H_in)
    tmp = apply_line_resample(x_v, plan.pass_v, statics.statics_v, border_value)
    # (N, W_in, C, H_out) -> pass H layout: lines = output rows.
    x_h = tmp.transpose(0, 3, 2, 1)                        # (N, H_out, C, W_in)
    out = apply_line_resample(x_h, plan.pass_h, statics.statics_h, border_value)

    out = out.transpose(0, 1, 3, 2)                        # (N, H_out, W_out, C)
    if orig_dtype == jnp.uint8:
        out = jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)
    else:
        out = out.astype(orig_dtype)
    if not had_c:
        out = out[..., 0]
    return out


def warp_affine_batch_mxu(
    images,
    trans_mats: np.ndarray,
    dst_shape: Optional[Tuple[int, int]] = None,
    border_value: float = 0.0,
):
    """Convenience wrapper: plan on host, jit-apply on device."""
    src_shape = (images.shape[1], images.shape[2])
    plan, statics = plan_affine_warp(trans_mats, src_shape, dst_shape)
    fn = jax.jit(
        apply_affine_warp, static_argnames=('statics', 'border_value')
    )
    return fn(images, plan, statics=statics, border_value=border_value)


# ---------------------------------------------------------------------------
# Quadrant reduction: ANY affine matrix (rotations past 45 degrees included)
# through the two-shear program.  Factor F = F' o Q with Q a rot90^k pixel
# map; the device rotates each sample by its k (flips/transposes — layout
# moves, no arithmetic) and the exact 3-tap program applies F', whose
# two-shear decomposition is well-conditioned (|inv a| >= cos 45).
# ---------------------------------------------------------------------------


def _rot90_coord_mats(h: int, w: int) -> np.ndarray:
    """Q_k^{-1} as 3x3 mats on (x, y, 1): source coord of a pixel in the
    k-times-CCW-rotated image (np.rot90 on (H, W) axes).  k in {1, 3}
    assume a square image (the reducer only picks them when h == w)."""
    s = float(h - 1)
    return np.asarray([
        [[1, 0, 0], [0, 1, 0], [0, 0, 1]],
        # rot90(img, 1)[y, x] = img[x, s - y]
        [[0, -1, s], [1, 0, 0], [0, 0, 1]],
        [[-1, 0, w - 1.0], [0, -1, h - 1.0], [0, 0, 1]],
        [[0, 1, 0], [-1, 0, s], [0, 0, 1]],
    ], dtype=np.float64)


def quadrant_reduce_mats(
    trans_mats: np.ndarray,
    src_shape: Tuple[int, int],
) -> Tuple[np.ndarray, np.ndarray]:
    """(k (N,) int8, reduced forward mats (N, 3, 3)).

    Picks per-sample k maximizing the two-shear conditioning of
    F' = F @ Qinv_k.  Non-square sources only consider k in {0, 2}."""
    trans_mats = np.asarray(trans_mats, dtype=np.float64)
    if trans_mats.shape[1:] == (2, 3):
        bottom = np.tile([[0.0, 0.0, 1.0]], (len(trans_mats), 1, 1))
        trans_mats = np.concatenate([trans_mats, bottom], axis=1)
    h, w = src_shape
    qinv = _rot90_coord_mats(h, w)
    ks = (0, 1, 2, 3) if h == w else (0, 2)
    n = len(trans_mats)
    best_k = np.zeros(n, dtype=np.int8)
    best_score = np.full(n, -1.0)
    reduced = trans_mats.copy()
    for k in ks:
        cand = trans_mats @ qinv[k][None]
        inv = np.linalg.inv(cand)
        # Conditioning of the decomposition: normalized SIGNED inv[0, 0]
        # (the pass-H slope is a; beta etc. stay bounded when a dominates
        # its row).  Positive wins: for orientation-preserving mats a > 0
        # implies beta > 0 too, so all samples resample forward and their
        # per-pass index spans align instead of adding.
        a = inv[:, 0, 0]
        norm = np.sqrt(inv[:, 0, 0] ** 2 + inv[:, 0, 1] ** 2)
        score = a / np.maximum(norm, 1e-12)
        take = score > best_score
        best_score = np.where(take, score, best_score)
        best_k = np.where(take, k, best_k).astype(np.int8)
        reduced[take] = cand[take]
    return best_k, reduced


@partial(jax.jit, static_argnames=('statics', 'border_value'))
def apply_affine_warp_quad(
    images,
    quadrants,
    plan: AffineWarpPlan,
    statics: AffineWarpStatics,
    border_value: float = 0.0,
):
    """Per-sample rot90 by ``quadrants`` (N,) int, then the exact two-shear
    warp.  Square sources only for quadrants 1/3 (the reducer guarantees
    this)."""
    had_c = images.ndim == 4
    if not had_c:
        images = images[..., None]
    h, w = images.shape[1], images.shape[2]
    q = quadrants[:, None, None, None]
    flipped = images[:, ::-1, ::-1]                    # rot180
    if h == w:
        r1 = jnp.rot90(images, 1, (1, 2))
        r3 = jnp.rot90(images, 3, (1, 2))
        images = jnp.where(
            (q == 0), images,
            jnp.where(q == 1, r1, jnp.where(q == 2, flipped, r3)),
        )
    else:
        images = jnp.where(q == 2, flipped, images)
    out = apply_affine_warp(
        images, plan, statics, border_value=border_value
    )
    return out if had_c else out[..., 0]


# ---------------------------------------------------------------------------
# Dense displacement-field warp (camera models / MLS): the same two-pass
# shifts+matmuls scheme generalized to arbitrary smooth backward fields.
# Per-line offsets absorb the field's dominant structure (the curve) as
# free integer shifts; the leftover per-pixel residual widens the tap
# count from 3 to T (T matmul-accumulate rounds, still gather-free).
# ---------------------------------------------------------------------------


class DenseLinePlan(NamedTuple):
    i0: jnp.ndarray      # (N, J) int32: floor(slope_n * j) - i0_min
    starts: jnp.ndarray  # (N, L) int32
    u: jnp.ndarray       # (N, L, J) f32: tap-space position in [0, T-2]


class DenseLineStatics(NamedTuple):
    pad_lo: int
    m_padded: int
    m_shift: int
    out_len: int
    taps: int


def plan_dense_line_resample(
    pos: np.ndarray,
    in_len: int,
    taps_max: int = 24,
) -> Tuple[DenseLinePlan, DenseLineStatics]:
    """Plan resampling lines at arbitrary positions.

    ``pos``: (N, L, J) float64 — source coordinate (along the resampled
    axis) for line l, output index j.  The per-line offset and a shared
    per-sample slope are factored out; what remains determines the tap
    count T.  Fields whose non-separable residual exceeds ``taps_max``
    taps are rejected (use the host path for those).
    """
    pos = np.asarray(pos, dtype=np.float64)
    n, l, j = pos.shape

    slopes = (pos[:, :, -1] - pos[:, :, 0]).mean(axis=1) / max(j - 1, 1)
    jj = np.arange(j, dtype=np.float64)
    i0_abs = np.floor(slopes[:, None] * jj[None, :]).astype(np.int64)  # (N, J)
    rel = pos - i0_abs[:, None, :]
    k = np.floor(rel.min(axis=2)).astype(np.int64)                     # (N, L)
    u = (rel - k[:, :, None]).astype(np.float32)                       # >= 0

    taps = int(np.ceil(float(u.max()))) + 2
    assert taps <= taps_max, (
        f'dense field needs {taps} taps (> {taps_max}); field is too '
        'non-separable for the device path — use the host remap'
    )
    # Statics select the compiled program: quantize them hard so randomized
    # batches reuse one compilation (extra taps/width cost a few masked
    # matmul rounds; a recompile costs far more).
    taps = 6 if taps <= 6 else (12 if taps <= 12 else taps_max)

    # Per-sample offset: mixed slope signs across a batch must not ADD
    # their spans (a +1 and a -1 slope would otherwise double m_shift).
    i0_min = i0_abs.min(axis=1)                                     # (N,)
    m_shift = int((i0_abs.max(axis=1) - i0_min).max()) + taps
    m_shift = -(-m_shift // 64) * 64

    starts_src = k + i0_min[:, None]
    pad_lo = _round_up(max(0, -int(starts_src.min())), 128)
    m_padded = _round_up(
        max(in_len + pad_lo, int(starts_src.max()) + pad_lo + _ROLL_WINDOW),
        128,
    )
    # Feasible iff SOME shift kernel covers the window: the padded
    # roll-window path (m_shift <= window - 128) or the borderless
    # 2048-lane slab path (the same window_ok test the apply uses).
    rel_min = -pad_lo
    rel_max = m_padded - _ROLL_WINDOW - pad_lo
    slab_ok = (
        in_len + m_shift <= 2048
        and rel_min >= -(2048 - in_len - m_shift)
        and rel_max <= 2048 - m_shift
    )
    assert slab_ok or m_shift <= _ROLL_WINDOW - 128, (
        f'shift window {m_shift} (in_len {in_len}) exceeds both kernels'
    )

    plan = DenseLinePlan(
        i0=jnp.asarray((i0_abs - i0_min[:, None]).astype(np.int32)),
        starts=jnp.asarray((starts_src + pad_lo).astype(np.int32)),
        u=jnp.asarray(u),
    )
    statics = DenseLineStatics(
        pad_lo=pad_lo, m_padded=m_padded, m_shift=m_shift,
        out_len=j, taps=taps,
    )
    return plan, statics


def apply_dense_line_resample(
    x,
    plan: DenseLinePlan,
    statics: DenseLineStatics,
    border_value: float = 0.0,
):
    """Resample (N, L, C, M_in) -> (N, L, C, out_len) at planned positions."""
    n, l, c, m_in = x.shape
    shifted = row_shift(
        x, plan.starts - statics.pad_lo, statics.m_shift,
        border_value=border_value,
    )                                                     # (N, L, C, m_shift)

    jn = statics.out_len
    iota_m = jnp.arange(statics.m_shift, dtype=jnp.int32)[None, :, None]
    u = plan.u[:, :, None]                                # (N, L, 1, J)

    # Accumulate tap-by-tap: T matmuls, never materializing (N,L,C,T,J).
    out = jnp.zeros((n, l, c, jn), dtype=jnp.float32)
    for t in range(statics.taps):
        g_t = (iota_m == (plan.i0 + t)[:, None, :]).astype(x.dtype)
        a_t = jnp.einsum(
            'nlcm,nmj->nlcj', shifted, g_t, preferred_element_type=jnp.float32,
            precision=lax.Precision.HIGHEST,
        )
        w_t = jnp.maximum(1.0 - jnp.abs(u - t), 0.0)
        out = out + a_t * w_t
    return out


class DenseWarpPlan(NamedTuple):
    pass_v: DenseLinePlan
    pass_h: DenseLinePlan


class DenseWarpStatics(NamedTuple):
    statics_v: DenseLineStatics
    statics_h: DenseLineStatics


def line_tap_needs(pos: np.ndarray) -> np.ndarray:
    """Per-sample tap requirement of the shared-slope scheme for (N, L, J)
    positions — the per-sample form of plan_dense_line_resample's check."""
    pos = np.asarray(pos, dtype=np.float64)
    n, l, j = pos.shape
    slopes = (pos[:, :, -1] - pos[:, :, 0]).mean(axis=1) / max(j - 1, 1)
    jj = np.arange(j, dtype=np.float64)
    i0_abs = np.floor(slopes[:, None] * jj[None, :])
    rel = pos - i0_abs[:, None, :]
    u = rel - np.floor(rel.min(axis=2))[:, :, None]
    return np.ceil(u.max(axis=(1, 2))).astype(np.int64) + 2


def line_window_needs(pos: np.ndarray) -> np.ndarray:
    """Per-sample shift-window requirement (i0 span) of the shared-slope
    scheme — samples beyond the roll window must take the host path."""
    pos = np.asarray(pos, dtype=np.float64)
    n, l, j = pos.shape
    slopes = (pos[:, :, -1] - pos[:, :, 0]).mean(axis=1) / max(j - 1, 1)
    return np.ceil(np.abs(slopes) * (j - 1)).astype(np.int64)


def dense_warp_positions(
    map_ys: np.ndarray,
    map_xs: np.ndarray,
    src_shape: Tuple[int, int],
):
    """(pos_v, map_xs_fixed, row_monotone): the two passes' position
    arrays + a per-sample monotonicity flag.

    Samples whose map_x rows are badly non-monotone cannot use the
    two-pass decomposition at all; callers route those to the host remap.
    """
    map_ys = np.asarray(map_ys, dtype=np.float64)
    map_xs = np.asarray(map_xs, dtype=np.float64)
    n, h_out, w_out = map_xs.shape
    h_in, w_in = src_shape

    dx = np.diff(map_xs, axis=2)
    row_monotone = dx.reshape(n, -1).min(axis=1) > -0.5
    if dx.min() <= 0:
        # Repair tiny seams (grid-cell rounding) with a running max.
        map_xs = np.maximum.accumulate(map_xs, axis=2)

    # Pass V positions: g(y, u) = map_y(y, x*(y, u)) with map_x(y, x*) = u,
    # for u over the INPUT column grid.  Rows are monotone in x, so x* is a
    # 1-D interpolation per row.  Outside the row's x-range EXTRAPOLATE
    # linearly (np.interp clamps, and a clamped g flattens per-line slopes
    # at rotated-canvas corners — tap needs then explode and the sample
    # falls off the device path).
    u_grid = np.arange(w_in, dtype=np.float64)
    out_grid = np.arange(w_out, dtype=np.float64)
    g = np.empty((n, h_out, w_in), dtype=np.float64)
    for idx in range(n):
        for y in range(h_out):
            xs_row = map_xs[idx, y]
            ys_row = map_ys[idx, y]
            x_star = np.interp(u_grid, xs_row, out_grid)
            lo, hi = xs_row[0], xs_row[-1]
            sx = (w_out - 1) / max(hi - lo, 1e-9)
            left = u_grid < lo
            if left.any():
                x_star[left] = (u_grid[left] - lo) * sx
            right = u_grid > hi
            if right.any():
                x_star[right] = (w_out - 1) + (u_grid[right] - hi) * sx
            row_g = np.interp(x_star, out_grid, ys_row)
            sy = (ys_row[-1] - ys_row[0]) / max(w_out - 1, 1)
            left = x_star < 0
            if left.any():
                row_g[left] = ys_row[0] + x_star[left] * sy
            right = x_star > w_out - 1
            if right.any():
                row_g[right] = ys_row[-1] + (x_star[right] - (w_out - 1)) * sy
            g[idx, y] = row_g
    # Pass V resamples along the source rows for each input column u:
    # lines = u (W_in), positions over y = g[., y, u] -> transpose.
    pos_v = g.transpose(0, 2, 1)                       # (N, W_in, H_out)
    return pos_v, map_xs, row_monotone


def plan_dense_warp_from_positions(
    pos_v: np.ndarray,
    map_xs: np.ndarray,
    src_shape: Tuple[int, int],
    taps_max: int = 24,
) -> Tuple[DenseWarpPlan, DenseWarpStatics]:
    h_in, w_in = src_shape
    plan_v, statics_v = plan_dense_line_resample(pos_v, h_in, taps_max)
    plan_h, statics_h = plan_dense_line_resample(map_xs, w_in, taps_max)
    return (
        DenseWarpPlan(pass_v=plan_v, pass_h=plan_h),
        DenseWarpStatics(statics_v=statics_v, statics_h=statics_h),
    )


def plan_dense_warp(
    map_ys: np.ndarray,
    map_xs: np.ndarray,
    src_shape: Tuple[int, int],
    taps_max: int = 24,
) -> Tuple[DenseWarpPlan, DenseWarpStatics]:
    """Two-pass plan for arbitrary backward fields (host-side).

    ``map_ys``/``map_xs``: (N, H_out, W_out) float — for each output pixel,
    the source coordinate to sample (cv2.remap convention; this is exactly
    what grid_rendering's generate_remap_params emits per sample).
    Requires ``map_x`` monotonically increasing along each output row
    (true for camera-model and mild MLS warps).
    """
    pos_v, map_xs_fixed, row_monotone = dense_warp_positions(
        map_ys, map_xs, src_shape
    )
    assert row_monotone.all(), (
        'map_x must be (near-)monotone along rows for the two-pass '
        'decomposition'
    )
    return plan_dense_warp_from_positions(
        pos_v, map_xs_fixed, src_shape, taps_max
    )


def apply_dense_warp(
    images,
    plan: DenseWarpPlan,
    statics: DenseWarpStatics,
    border_value: float = 0.0,
):
    """Warp (N, H, W, C) by the planned dense field (jittable)."""
    had_c = images.ndim == 4
    if not had_c:
        images = images[..., None]
    orig_dtype = images.dtype
    x = images.astype(jnp.float32)

    # Pass V: lines = input columns; resample along source rows (slab).
    x_v = x.transpose(0, 2, 3, 1)                          # (N, W_in, C, H_in)
    tmp = apply_dense_line_resample(
        x_v, plan.pass_v, statics.statics_v, border_value
    )
    # (N, W_in, C, H_out) -> pass H layout: lines = output rows.
    x_h = tmp.transpose(0, 3, 2, 1)                        # (N, H_out, C, W_in)
    out = apply_dense_line_resample(
        x_h, plan.pass_h, statics.statics_h, border_value
    )

    out = out.transpose(0, 1, 3, 2)                        # (N, H_out, W_out, C)
    if orig_dtype == jnp.uint8:
        out = jnp.clip(jnp.round(out), 0, 255).astype(jnp.uint8)
    else:
        out = out.astype(orig_dtype)
    if not had_c:
        out = out[..., 0]
    return out


def warp_dense_batch_mxu(
    images,
    map_ys: np.ndarray,
    map_xs: np.ndarray,
    border_value: float = 0.0,
    taps_max: int = 24,
):
    """Convenience wrapper: plan on host, jit-apply on device."""
    src_shape = (images.shape[1], images.shape[2])
    plan, statics = plan_dense_warp(map_ys, map_xs, src_shape, taps_max)
    fn = jax.jit(
        apply_dense_warp, static_argnames=('statics', 'border_value')
    )
    return fn(images, plan, statics=statics, border_value=border_value)
