"""Batched device forms of the text-region hot loops.

The adaptive-scaling stage (pipeline/text_detection/page_text_region.py,
behavioral spec vkit/pipeline/text_detection/page_text_region.py:561-858)
rotates every flattened text region to horizontal and resizes it to a
target char height — per-region host warps in the reference.  Here the
rotate+resize compose into ONE affine matrix per region and the whole
region batch runs through the two-shear warp (ops/warp_mxu.py) in a
single program; uniform tile canvases keep shapes static.

The per-char gaussian heatmaps (engine/char_heatmap/default.py, spec
vkit/engine/char_heatmap/default.py:30-195 + page_text_region_label.py:443)
warp a gaussian bump into each char quad — per-char cv.warpPerspective in
the reference.  The device form evaluates the bump ANALYTICALLY at the
inverse-homography coordinates (elementwise math, no gathers): one
program for every char tile.
"""
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np


# ---------------------------------------------------------------------------
# Region flatten: rotate-to-horizontal + resize, one affine program.
# ---------------------------------------------------------------------------


def plan_region_flatten(
    angles_deg: Sequence[float],
    scales: Sequence[float],
    src_tile: int,
    dst_tile: int,
    content_extents: Optional[np.ndarray] = None,
):
    """Per-region forward mats: scale about the ROTATED content origin.

    Each region patch lives in the top-left of its (src_tile, src_tile)
    canvas; the region rotates by its flattening angle about the canvas
    center, then translates so the rotated CONTENT bounding box's corner
    sits at the dst origin, then scales — the flatten-trim-resize chain
    of FlattenedTextRegion composed into one resampling pass.

    ``content_extents``: optional (R, 2) int (h, w) — each region's real
    content extent inside its padded square tile (default: the full
    tile).  The translation zeroes the rotated CONTENT bbox, so smaller
    regions land at the dst origin instead of floating inside the
    rotated-canvas bbox.

    Returns (mats (R, 3, 3) float64, out_extents (R, 2) int (h, w): the
    rotated + scaled content extent inside the dst tile).
    """
    angles = np.asarray(angles_deg, dtype=np.float64)
    scales_np = np.asarray(scales, dtype=np.float64)
    n = len(angles)
    c = (src_tile - 1) / 2.0
    rad = np.deg2rad(angles)
    cos = np.cos(rad)
    sin = np.sin(rad)

    if content_extents is None:
        hw = np.full((n, 2), src_tile, dtype=np.float64)
    else:
        hw = np.asarray(content_extents, dtype=np.float64)
    # Content rect corners per region, (R, 4, 2) xy.
    zeros = np.zeros(n)
    ws = hw[:, 1] - 1.0
    hs = hw[:, 0] - 1.0
    corners = np.stack([
        np.stack([zeros, zeros], axis=1),
        np.stack([ws, zeros], axis=1),
        np.stack([ws, hs], axis=1),
        np.stack([zeros, hs], axis=1),
    ], axis=1)

    rot = np.zeros((n, 3, 3), dtype=np.float64)
    rot[:, 0, 0] = cos
    rot[:, 0, 1] = -sin
    rot[:, 0, 2] = c - cos * c + sin * c
    rot[:, 1, 0] = sin
    rot[:, 1, 1] = cos
    rot[:, 1, 2] = c - sin * c - cos * c
    rot[:, 2, 2] = 1.0
    xy = np.einsum('nij,nkj->nki', rot[:, :2, :2], corners) \
        + rot[:, None, :2, 2]
    shift = xy.min(axis=1)                                  # (R, 2)
    span = xy.max(axis=1) - shift                           # (R, 2) xy
    mats = rot
    mats[:, :2, 2] -= shift
    mats[:, :2] *= scales_np[:, None, None]
    extents = (
        np.ceil(span[:, ::-1] * scales_np[:, None] - 1e-6).astype(np.int64)
        + 1
    )
    extents = np.minimum(extents, dst_tile)
    return mats, extents


def region_flatten_point_map(mats: np.ndarray, groups, points_xy):
    """Forward-map per-region point sets through the flatten mats.

    ``groups``: (P,) int region index per point; ``points_xy``: (P, 2)
    float xy in each point's region-tile coordinates.  Returns (P, 2)
    float64 xy in the region's dst-tile frame — the analytic co-transform
    of the flattened char polygons (one einsum, no per-region loop)."""
    xy = np.asarray(points_xy, dtype=np.float64).reshape(-1, 2)
    m = np.asarray(mats, dtype=np.float64)[np.asarray(groups, dtype=np.int64)]
    homo = np.concatenate([xy, np.ones((len(xy), 1))], axis=1)
    out = np.einsum('pij,pj->pi', m, homo)
    return out[:, :2] / out[:, 2:3]


def batch_flatten_regions(
    patches,
    angles_deg: Sequence[float],
    scales: Sequence[float],
    dst_tile: int,
    border_value: float = 0.0,
    content_extents: Optional[np.ndarray] = None,
    return_mats: bool = False,
):
    """Rotate+scale every (src_tile, src_tile, C) region patch in ONE
    two-shear program -> (R, dst_tile, dst_tile, C) float32.

    Returns (warped, extents (R, 2) (h, w)): content occupies
    [:eh, :ew] of each dst tile.  With ``return_mats`` also the (R, 3, 3)
    forward mats (for the analytic char-polygon co-transform,
    region_flatten_point_map)."""
    from .warp_mxu import (
        apply_affine_warp,
        apply_affine_warp_quad,
        plan_affine_warp,
        quadrant_reduce_mats,
    )

    patches = jnp.asarray(patches)
    src_tile = int(patches.shape[1])
    assert patches.shape[2] == src_tile, 'square source tiles required'
    mats, extents = plan_region_flatten(
        angles_deg, scales, src_tile, dst_tile,
        content_extents=content_extents,
    )
    quads, reduced = quadrant_reduce_mats(mats, (src_tile, src_tile))
    plan, statics = plan_affine_warp(
        reduced, (src_tile, src_tile), (dst_tile, dst_tile), canonical=True
    )
    if (quads == 0).all():
        fn = jax.jit(
            apply_affine_warp, static_argnames=('statics', 'border_value')
        )
        warped = fn(patches, plan, statics=statics,
                    border_value=border_value)
    else:
        warped = apply_affine_warp_quad(
            patches, jnp.asarray(quads), plan, statics=statics,
            border_value=border_value,
        )
    if return_mats:
        return warped, extents, mats
    return warped, extents


# ---------------------------------------------------------------------------
# Char heatmap tiles: analytic gaussian bump through per-char inverse
# homographies.
# ---------------------------------------------------------------------------


def plan_char_heatmap_mats(
    quads_xy: np.ndarray,
    char_radius: int = 25,
) -> np.ndarray:
    """Inverse homographies mapping tile coords -> bump coords.

    ``quads_xy``: (G, 4, 2) float, each char's polygon corners RELATIVE
    to its own tile origin (the char bbox corner), ordered like
    Box.to_polygon.  The bump square spans [0, 2*radius]."""
    from .warp import solve_perspective_batch

    edge = 2 * char_radius
    bump_quad = np.asarray(
        [(0, 0), (edge, 0), (edge, edge), (0, edge)], dtype=np.float64
    )
    g = len(quads_xy)
    mats = solve_perspective_batch(
        np.broadcast_to(bump_quad, (g, 4, 2)),
        np.asarray(quads_xy, dtype=np.float64),
    )
    return np.linalg.inv(mats)


import functools


@functools.partial(
    jax.jit, static_argnames=('tile', 'char_radius', 'distance_factor')
)
def char_heatmap_tiles(
    mats_inv,
    tile: Optional[int] = None,
    char_radius: int = 25,
    distance_factor: float = 2.25,
):
    """(G, T, T) gaussian bump tiles, evaluated analytically.

    Per pixel: uv = H_inv @ (x, y, 1); r = ||uv - radius|| / radius;
    value = exp(-0.5 * (factor * r)^2), zero outside the bump square —
    the device twin of warping the sampled bump raster (differences are
    bounded by the host path's bilinear interpolation step)."""
    mats_inv = jnp.asarray(mats_inv, dtype=jnp.float32)
    t = tile if tile is not None else 64
    xs = jnp.arange(t, dtype=jnp.float32)[None, :]
    ys = jnp.arange(t, dtype=jnp.float32)[:, None]
    ones = jnp.ones((t, t), dtype=jnp.float32)
    # (G, 3, T, T) = H_inv @ (x, y, 1)
    uvw = jnp.einsum(
        'gij,jhw->gihw',
        mats_inv,
        jnp.stack([jnp.broadcast_to(xs, (t, t)),
                   jnp.broadcast_to(ys, (t, t)), ones]),
        precision=lax.Precision.HIGHEST,
    )
    w = jnp.where(jnp.abs(uvw[:, 2]) < 1e-9, 1e-9, uvw[:, 2])
    u = uvw[:, 0] / w
    v = uvw[:, 1] / w
    radius = float(char_radius)
    edge = 2.0 * radius
    r = jnp.sqrt((u - radius) ** 2 + (v - radius) ** 2) / radius
    value = jnp.exp(-0.5 * (distance_factor * r) ** 2)
    inside = (u >= 0) & (u <= edge) & (v >= 0) & (v <= edge)
    return jnp.where(inside, value, 0.0)


def batch_char_heatmaps(
    quads_xy: np.ndarray,
    tile: int = 64,
    char_radius: int = 25,
    distance_factor: float = 2.25,
):
    """Host-plan + device-evaluate all char bump tiles in one program.

    The tile count pads to a power of two (min 64): it is part of the
    compiled signature, and every synthesized batch carries a different
    char count — without the pad this program would recompile per batch.
    Padded rows are identity bumps; callers index only the real rows."""
    mats_inv = plan_char_heatmap_mats(quads_xy, char_radius)
    count = len(mats_inv)
    padded = 64
    while padded < count:
        padded *= 2
    if padded > count:
        fill = np.broadcast_to(
            np.eye(3, dtype=np.float64), (padded - count, 3, 3)
        )
        mats_inv = np.concatenate([mats_inv, fill], axis=0)
    return char_heatmap_tiles(
        jnp.asarray(mats_inv, dtype=jnp.float32),
        tile=tile, char_radius=char_radius,
        distance_factor=distance_factor,
    )


# ---------------------------------------------------------------------------
# Region window gather: device slices of the warped page batch.
# ---------------------------------------------------------------------------


@functools.partial(jax.jit, static_argnames=('tile',))
def gather_region_windows(
    images,
    active,
    sids,
    ups,
    lefts,
    heights,
    widths,
    quads_xy,
    tile: int,
):
    """One device program building every region's source patch in place.

    Replaces the host loop that sliced each window out of a FETCHED page
    batch and re-uploaded the region stacks (synth/region.py round 4):
    the pages never leave the device.  Per region: dynamic-slice a
    (tile, tile) window at (up, left) of page ``sid``, gate the rgb to
    the window extent, and build the alpha as the page active raster
    intersected with the region's dilated word polygon (crossing-number
    test in window-relative coords — the reference masks flattened
    regions to the extended region polygon,
    vkit/pipeline/text_detection/page_text_region.py:478-558).

    ``quads_xy``: (R, 4, 2) f32 polygon corners relative to each window's
    origin.  Returns (R, tile, tile, 4) float32 (rgb + alpha).
    """
    imgs = images.astype(jnp.float32)
    act = active.astype(jnp.float32)
    # Pad pages so edge windows never clamp (dynamic_slice shifts starts
    # that overrun, which would misalign window-relative coordinates).
    imgs = jnp.pad(imgs, ((0, 0), (0, tile), (0, tile), (0, 0)))
    act = jnp.pad(act, ((0, 0), (0, tile), (0, tile)))
    ys = jnp.arange(tile, dtype=jnp.float32)[:, None]
    xs = jnp.arange(tile, dtype=jnp.float32)[None, :]

    def inside_poly(quad):
        x0 = quad[:, 0][:, None, None]
        y0 = quad[:, 1][:, None, None]
        x1 = jnp.roll(quad[:, 0], -1)[:, None, None]
        y1 = jnp.roll(quad[:, 1], -1)[:, None, None]
        y = ys[None]
        x = xs[None]
        crossing = ((y0 <= y) & (y1 > y)) | ((y1 <= y) & (y0 > y))
        dy = jnp.where(jnp.abs(y1 - y0) < 1e-12, 1e-12, y1 - y0)
        cx = x0 + (y - y0) / dy * (x1 - x0)
        hits = (crossing & (x < cx)).astype(jnp.int32).sum(axis=0)
        return (hits % 2 == 1).astype(jnp.float32)

    def body(_, row):
        sid, up, left, h, w, quad = row
        img = jax.lax.dynamic_slice(
            imgs, (sid, up, left, 0), (1, tile, tile, imgs.shape[3])
        )[0]
        a = jax.lax.dynamic_slice(act, (sid, up, left), (1, tile, tile))[0]
        in_extent = ((ys < h) & (xs < w)).astype(jnp.float32)
        alpha = a * inside_poly(quad) * in_extent
        rgb = img * in_extent[..., None]
        return 0, jnp.concatenate([rgb, alpha[..., None]], axis=-1)

    _, out = jax.lax.scan(
        body, 0,
        (jnp.asarray(sids, jnp.int32), jnp.asarray(ups, jnp.int32),
         jnp.asarray(lefts, jnp.int32),
         jnp.asarray(heights, jnp.float32), jnp.asarray(widths, jnp.float32),
         jnp.asarray(quads_xy, jnp.float32)),
    )
    return out
