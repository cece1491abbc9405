"""Device glyph compositing: scatter/alpha-blend glyph quads onto a canvas.

The reference paints text per char on the host: FreeType rasterizes a
glyph, the line canvas is filled through a mask, the finished line raster
is resized to its layout box and alpha-blended onto the page
(vkit/engine/font/freetype.py:383-493, vkit/pipeline/text_detection/
page_assembler.py text-line fill).  That is thousands of tiny numpy ops
per page.

The device form is ONE compiled program per page batch:

  - glyph ink lives in a device-resident atlas, (V, T, T) float32 alpha,
    one fixed-size tile per distinct (font, size, char);
  - a placement table (struct-of-arrays, padded to a bucket size) lists
    every glyph quad: atlas id, batch sample, destination box, color;
  - a `lax.scan` walks the table; each step rescales the tile to its
    destination box with bilinear TAP-WEIGHT MATMULS (no gathers; the
    (S, T) weight matrices are built from traced scales) and alpha-blends the
    S x S patch into the canvas via dynamic_update_slice.

Static shapes throughout: tiles are atlas-uniform, destination patches are
a fixed S x S, and the scan length is the (padded) table length.  Per-glyph
scale factors are traced scalars, so one compilation serves every page.
"""
import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax


class GlyphPlacements(NamedTuple):
    """One row per glyph quad; a valid jit input pytree.

    Destination boxes use UNPADDED canvas coordinates; `up`/`left` may be
    negative down to -out_tile (the compositor pads the canvas).  Rows with
    ``valid == 0`` are no-ops (bucket padding).
    """
    glyph_ids: jnp.ndarray    # (G,) i32 — atlas tile index
    sample_ids: jnp.ndarray   # (G,) i32 — batch sample
    ups: jnp.ndarray          # (G,) i32 — dst box up (canvas coords)
    lefts: jnp.ndarray        # (G,) i32
    dst_hs: jnp.ndarray       # (G,) i32 — dst box extents, <= out_tile
    dst_ws: jnp.ndarray       # (G,) i32
    src_hs: jnp.ndarray       # (G,) f32 — glyph ink extents inside the tile
    src_ws: jnp.ndarray       # (G,) f32
    colors: jnp.ndarray       # (G, C) f32 — blend color per glyph
    valids: jnp.ndarray       # (G,) f32 in {0, 1}

    @property
    def num_rows(self) -> int:
        return int(self.glyph_ids.shape[0])


def build_placements(
    rows,
    num_channels: int = 3,
    bucket: int = 256,
) -> GlyphPlacements:
    """Pack host placement rows into a bucket-padded GlyphPlacements.

    ``rows``: iterable of dicts with keys glyph_id, sample_id, up, left,
    dst_h, dst_w, src_h, src_w, color.  The table pads to ``bucket`` or the
    next power of two above the row count, so at most log2 distinct scan
    lengths ever compile.
    """
    rows = list(rows)
    count = len(rows)
    padded = bucket
    while padded < count:
        padded *= 2

    glyph_ids = np.zeros(padded, dtype=np.int32)
    sample_ids = np.zeros(padded, dtype=np.int32)
    ups = np.zeros(padded, dtype=np.int32)
    lefts = np.zeros(padded, dtype=np.int32)
    dst_hs = np.ones(padded, dtype=np.int32)
    dst_ws = np.ones(padded, dtype=np.int32)
    src_hs = np.ones(padded, dtype=np.float32)
    src_ws = np.ones(padded, dtype=np.float32)
    colors = np.zeros((padded, num_channels), dtype=np.float32)
    valids = np.zeros(padded, dtype=np.float32)

    for idx, row in enumerate(rows):
        glyph_ids[idx] = row['glyph_id']
        sample_ids[idx] = row['sample_id']
        ups[idx] = row['up']
        lefts[idx] = row['left']
        dst_hs[idx] = row['dst_h']
        dst_ws[idx] = row['dst_w']
        src_hs[idx] = row['src_h']
        src_ws[idx] = row['src_w']
        colors[idx] = row['color']
        valids[idx] = 1.0

    return GlyphPlacements(
        glyph_ids=jnp.asarray(glyph_ids),
        sample_ids=jnp.asarray(sample_ids),
        ups=jnp.asarray(ups),
        lefts=jnp.asarray(lefts),
        dst_hs=jnp.asarray(dst_hs),
        dst_ws=jnp.asarray(dst_ws),
        src_hs=jnp.asarray(src_hs),
        src_ws=jnp.asarray(src_ws),
        colors=jnp.asarray(colors),
        valids=jnp.asarray(valids),
    )


def _resample_weights(out_len: int, tap_len: int, src_extent, dst_extent):
    """(out_len, tap_len) bilinear tap weights mapping dst pixel i to the
    source coordinate (i + 0.5) * (src/dst) - 0.5 (half-pixel centers,
    cv2 INTER_LINEAR convention).  Taps falling outside [0, tap_len) drop
    out via the one-hot comparison, so ink fades to zero at tile edges
    exactly like the host path's resize-over-zero-padding.  Rows at or
    beyond ``dst_extent`` are zeroed (dst boxes smaller than the patch)."""
    i = jnp.arange(out_len, dtype=jnp.float32)
    scale = src_extent / jnp.maximum(dst_extent.astype(jnp.float32), 1.0)
    src = (i + 0.5) * scale - 0.5
    k0 = jnp.floor(src)
    frac = src - k0
    k0 = k0.astype(jnp.int32)
    k = jnp.arange(tap_len, dtype=jnp.int32)[None, :]
    weights = (
        (k == k0[:, None]).astype(jnp.float32) * (1.0 - frac)[:, None]
        + (k == (k0 + 1)[:, None]).astype(jnp.float32) * frac[:, None]
    )
    row_gate = (i < dst_extent.astype(jnp.float32)).astype(jnp.float32)
    return weights * row_gate[:, None]


def _resample_tile(w_y, tile, w_x):
    """``w_y @ tile @ w_x.T`` over the tile's two leading axes, in full
    f32: glyph alpha and paint are pixels the parity bounds hold."""
    return jnp.einsum('st,tu...,vu->sv...', w_y, tile, w_x,
                      precision=lax.Precision.HIGHEST)


@functools.partial(jax.jit, static_argnames=('out_tile',))
def composite_glyphs(
    canvas,
    tiles,
    placements: GlyphPlacements,
    out_tile: int = 64,
):
    """Alpha-blend every placement row onto the canvas in one program.

    ``canvas``: (N, H, W, C) uint8 or float32.
    ``tiles``: (V, T, T) float32 alpha in [0, 1].
    ``out_tile``: static destination patch size S; every dst box must
    satisfy dst_h <= S and dst_w <= S.

    Returns the blended canvas with the input dtype.  Blend rule per row:
    out = alpha * color + (1 - alpha) * out — the page assembler's
    text-line score-map fill (page_assembler.py) on device.
    """
    n, height, width, channels = canvas.shape
    tap = int(tiles.shape[1])
    s = out_tile

    orig_dtype = canvas.dtype
    work = canvas.astype(jnp.float32)
    # Pad so patches may hang off any edge without index clamping shifting
    # them (dynamic_update_slice clamps start indices).
    work = jnp.pad(work, ((0, 0), (s, s), (s, s), (0, 0)))

    def body(carry, row):
        (glyph_id, sample_id, up, left, dst_h, dst_w,
         src_h, src_w, color, valid) = row
        tile = jax.lax.dynamic_index_in_dim(tiles, glyph_id, 0, keepdims=False)
        w_y = _resample_weights(s, tap, src_h, dst_h)
        w_x = _resample_weights(s, tap, src_w, dst_w)
        alpha = _resample_tile(w_y, tile, w_x) * valid
        alpha = jnp.clip(alpha, 0.0, 1.0)[:, :, None]

        start = (sample_id, up + s, left + s, 0)
        region = jax.lax.dynamic_slice(
            carry, start, (1, s, s, channels)
        )[0]
        blended = alpha * color[None, None, :] + (1.0 - alpha) * region
        carry = jax.lax.dynamic_update_slice(
            carry, blended[None], start
        )
        return carry, None

    rows = (
        placements.glyph_ids,
        placements.sample_ids,
        placements.ups,
        placements.lefts,
        placements.dst_hs,
        placements.dst_ws,
        placements.src_hs,
        placements.src_ws,
        placements.colors,
        placements.valids,
    )
    work, _ = jax.lax.scan(body, work, rows)
    work = work[:, s:s + height, s:s + width, :]
    if jnp.issubdtype(orig_dtype, jnp.integer):
        info = jnp.iinfo(orig_dtype)
        return jnp.clip(jnp.round(work), info.min, info.max).astype(orig_dtype)
    return work.astype(orig_dtype)


@functools.partial(jax.jit, static_argnames=('out_tile',))
def composite_patches(
    canvas,
    tiles_alpha,
    tiles_rgb,
    use_rgbs,
    placements: GlyphPlacements,
    out_tile: int = 128,
):
    """composite_glyphs with optional per-patch RGB content.

    The above-text page layers (non-text symbols, seal stamps —
    page_assembler.py's post-text fills) are alpha patches whose paint is
    either a single color (seals) or an RGB image (symbols).
    ``tiles_rgb``: (V, T, T, 3) f32; ``use_rgbs``: (G,) f32 selecting the
    resampled RGB patch over the row color.  Scan order = z-order, same
    contract as composite_glyphs."""
    n, height, width, channels = canvas.shape
    tap = int(tiles_alpha.shape[1])
    s = out_tile

    orig_dtype = canvas.dtype
    work = canvas.astype(jnp.float32)
    work = jnp.pad(work, ((0, 0), (s, s), (s, s), (0, 0)))

    def body(carry, row):
        (glyph_id, sample_id, up, left, dst_h, dst_w,
         src_h, src_w, color, valid, use_rgb) = row
        tile = jax.lax.dynamic_index_in_dim(
            tiles_alpha, glyph_id, 0, keepdims=False
        )
        tile_rgb = jax.lax.dynamic_index_in_dim(
            tiles_rgb, glyph_id, 0, keepdims=False
        )
        w_y = _resample_weights(s, tap, src_h, dst_h)
        w_x = _resample_weights(s, tap, src_w, dst_w)
        alpha = _resample_tile(w_y, tile, w_x) * valid
        alpha = jnp.clip(alpha, 0.0, 1.0)[:, :, None]
        rgb = _resample_tile(w_y, tile_rgb, w_x)
        paint = color[None, None, :] * (1.0 - use_rgb) + rgb * use_rgb

        start = (sample_id, up + s, left + s, 0)
        region = jax.lax.dynamic_slice(
            carry, start, (1, s, s, channels)
        )[0]
        blended = alpha * paint + (1.0 - alpha) * region
        carry = jax.lax.dynamic_update_slice(carry, blended[None], start)
        return carry, None

    rows = (
        placements.glyph_ids,
        placements.sample_ids,
        placements.ups,
        placements.lefts,
        placements.dst_hs,
        placements.dst_ws,
        placements.src_hs,
        placements.src_ws,
        placements.colors,
        placements.valids,
        use_rgbs,
    )
    work, _ = jax.lax.scan(body, work, rows)
    work = work[:, s:s + height, s:s + width, :]
    if jnp.issubdtype(orig_dtype, jnp.integer):
        info = jnp.iinfo(orig_dtype)
        return jnp.clip(jnp.round(work), info.min, info.max).astype(orig_dtype)
    return work.astype(orig_dtype)


@functools.partial(jax.jit, static_argnames=('out_tile',))
def accumulate_glyph_alpha(
    alpha_canvas,
    tiles,
    placements: GlyphPlacements,
    out_tile: int = 64,
):
    """Max-accumulate glyph alpha into an (N, H, W) float32 canvas — the
    device twin of the text line's ScoreMap (keep_max_value fills) used
    for label rasters and mask thresholds."""
    n, height, width = alpha_canvas.shape
    tap = int(tiles.shape[1])
    s = out_tile

    work = jnp.pad(
        alpha_canvas.astype(jnp.float32), ((0, 0), (s, s), (s, s))
    )

    def body(carry, row):
        (glyph_id, sample_id, up, left, dst_h, dst_w,
         src_h, src_w, valid) = row
        tile = jax.lax.dynamic_index_in_dim(tiles, glyph_id, 0, keepdims=False)
        w_y = _resample_weights(s, tap, src_h, dst_h)
        w_x = _resample_weights(s, tap, src_w, dst_w)
        alpha = jnp.clip(_resample_tile(w_y, tile, w_x) * valid, 0.0, 1.0)
        start = (sample_id, up + s, left + s)
        region = jax.lax.dynamic_slice(carry, start, (1, s, s))[0]
        carry = jax.lax.dynamic_update_slice(
            carry, jnp.maximum(region, alpha)[None], start
        )
        return carry, None

    rows = (
        placements.glyph_ids,
        placements.sample_ids,
        placements.ups,
        placements.lefts,
        placements.dst_hs,
        placements.dst_ws,
        placements.src_hs,
        placements.src_ws,
        placements.valids,
    )
    work, _ = jax.lax.scan(body, work, rows)
    return work[:, s:s + height, s:s + width]


@functools.partial(jax.jit, static_argnames=('out_tile',))
def composite_patches_and_alpha(
    canvas,
    alpha_canvas,
    tiles_alpha,
    tiles_rgb,
    use_rgbs,
    placements: GlyphPlacements,
    out_tile: int = 128,
):
    """composite_patches + accumulate_glyph_alpha fused into ONE scan.

    The stacked-region composite ran both scans over the same placement
    rows (once for rgb, once for the active coverage) — the fused form
    resamples each tile once and halves the pass count.  Returns
    (blended canvas with the input dtype, max-accumulated (N, H, W) f32
    alpha canvas)."""
    n, height, width, channels = canvas.shape
    tap = int(tiles_alpha.shape[1])
    s = out_tile

    orig_dtype = canvas.dtype
    work = jnp.pad(
        canvas.astype(jnp.float32), ((0, 0), (s, s), (s, s), (0, 0))
    )
    work_a = jnp.pad(
        alpha_canvas.astype(jnp.float32), ((0, 0), (s, s), (s, s))
    )

    def body(carry, row):
        work, work_a = carry
        (glyph_id, sample_id, up, left, dst_h, dst_w,
         src_h, src_w, color, valid, use_rgb) = row
        tile = jax.lax.dynamic_index_in_dim(
            tiles_alpha, glyph_id, 0, keepdims=False
        )
        tile_rgb = jax.lax.dynamic_index_in_dim(
            tiles_rgb, glyph_id, 0, keepdims=False
        )
        w_y = _resample_weights(s, tap, src_h, dst_h)
        w_x = _resample_weights(s, tap, src_w, dst_w)
        alpha = jnp.clip(_resample_tile(w_y, tile, w_x) * valid, 0.0, 1.0)
        rgb = _resample_tile(w_y, tile_rgb, w_x)
        paint = color[None, None, :] * (1.0 - use_rgb) + rgb * use_rgb

        start = (sample_id, up + s, left + s, 0)
        region = jax.lax.dynamic_slice(
            work, start, (1, s, s, channels)
        )[0]
        blended = (
            alpha[:, :, None] * paint
            + (1.0 - alpha[:, :, None]) * region
        )
        work = jax.lax.dynamic_update_slice(work, blended[None], start)

        start_a = (sample_id, up + s, left + s)
        region_a = jax.lax.dynamic_slice(work_a, start_a, (1, s, s))[0]
        work_a = jax.lax.dynamic_update_slice(
            work_a, jnp.maximum(region_a, alpha)[None], start_a
        )
        return (work, work_a), None

    rows = (
        placements.glyph_ids,
        placements.sample_ids,
        placements.ups,
        placements.lefts,
        placements.dst_hs,
        placements.dst_ws,
        placements.src_hs,
        placements.src_ws,
        placements.colors,
        placements.valids,
        use_rgbs,
    )
    (work, work_a), _ = jax.lax.scan(body, (work, work_a), rows)
    work = work[:, s:s + height, s:s + width, :]
    work_a = work_a[:, s:s + height, s:s + width]
    if jnp.issubdtype(orig_dtype, jnp.integer):
        info = jnp.iinfo(orig_dtype)
        work = jnp.clip(
            jnp.round(work), info.min, info.max
        ).astype(orig_dtype)
    else:
        work = work.astype(orig_dtype)
    return work, work_a
