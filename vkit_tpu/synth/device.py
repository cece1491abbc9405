"""The batched device synthesis program: assemble -> distort -> label ->
resize for a page batch.

Pipeline (per batch of N host-prepped pages):
  1. assemble    — glyph compositing onto the background canvases
                   (ops/glyph.py, one scan program).
  2. photometric — randomized policy rounds over the full batch
                   (mechanism/batched_random.py, gated device programs).
  3. geometric   — one randomized WarpPlan per sample; ONE dense two-pass
                   warp moves the image AND the 4 label channels
                   together (mechanism/batched.batched_plan_warp).
  4. label fix   — the warped height channels are rescaled by the local
                   vertical stretch of the backward field (the device twin
                   of the reference recomputing heights from warped point
                   pairs, vkit/pipeline/text_detection/
                   page_distortion.py:163-223).
  5. resize      — tap-matmul resize of every channel to the static output
                   shape (the page_resizing step's dense work).

Label polygons co-transform analytically on the host (WarpPlan forward
point maps) — cheap, and exactly what the reference's point path computes.
"""
from typing import List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from numpy.random import Generator as RandomGenerator

from ..element import Box, Polygon
from ..engine.font.atlas import global_atlas_pack, pack_placements
from ..mechanism.batched import batched_plan_warp
from ..mechanism.batched_random import (
    batch_random_photometric_distort,
    sample_geometric_plans,
)
from ..ops.glyph import build_placements, composite_glyphs, composite_patches
from .prep import CHAR_HEIGHT, HostPage, TEXT_LINE_HEIGHT


_OVERLAY_TILE_LADDER = (64, 128, 192, 256, 384, 512)


def _split_oversized_overlay(sid, e, tile):
    """Chop a stamp larger than the tile ladder into <= tile sub-entries
    (adjacent, non-overlapping, so z-order within the stamp is moot).
    The reference assembler composites stamps of ANY size
    (vkit/pipeline/text_detection/page_assembler.py:154-274) — content
    must never be size-dropped."""
    import attr

    h, w = e.alpha.shape
    out = []
    for r0 in range(0, h, tile):
        for c0 in range(0, w, tile):
            r1, c1 = min(r0 + tile, h), min(c0 + tile, w)
            out.append((sid, attr.evolve(
                e,
                alpha=e.alpha[r0:r1, c0:c1],
                rgb=None if e.rgb is None else e.rgb[r0:r1, c0:c1],
                up=e.up + r0,
                left=e.left + c0,
            )))
    return out


def _composite_overlays(assembled, overlay):
    """Blend the ABOVE-TEXT page layers (symbols, seal stamps) in one
    device scan program (ops/glyph.composite_patches).  ``overlay``:
    [(sample_id, OverlayEntry)] in z-order.  Stamps beyond the tile
    ladder split into ladder-sized sub-tiles — nothing is dropped."""
    tile_max = _OVERLAY_TILE_LADDER[-1]
    flat = []
    for sid, e in overlay:
        if max(e.alpha.shape) <= tile_max:
            flat.append((sid, e))
        else:
            flat.extend(_split_oversized_overlay(sid, e, tile_max))
    overlay = flat
    if not overlay:
        return assembled
    max_dim = max(max(e.alpha.shape) for _, e in overlay)
    tile = next(t for t in _OVERLAY_TILE_LADDER if t >= max_dim)
    count = len(overlay)
    bucket = 8
    while bucket < count:
        bucket *= 2

    tiles_a = np.zeros((bucket, tile, tile), dtype=np.float32)
    tiles_rgb = np.zeros((bucket, tile, tile, 3), dtype=np.float32)
    rows = []
    use_rgbs = np.zeros(bucket, dtype=np.float32)
    for i, (sid, e) in enumerate(overlay):
        h, w = e.alpha.shape
        tiles_a[i, :h, :w] = e.alpha
        if e.rgb is not None:
            tiles_rgb[i, :h, :w] = e.rgb
            use_rgbs[i] = 1.0
        rows.append({
            'glyph_id': i, 'sample_id': sid, 'up': e.up, 'left': e.left,
            'dst_h': h, 'dst_w': w, 'src_h': float(h), 'src_w': float(w),
            'color': np.asarray(e.color, dtype=np.float32),
        })
    placements = build_placements(rows, bucket=bucket)
    return composite_patches(
        assembled, tiles_a, tiles_rgb, use_rgbs, placements, out_tile=tile
    )


class SynthBatchResult(NamedTuple):
    images: np.ndarray          # (N, out_h, out_w, 3) uint8
    label_stack: np.ndarray     # (N, out_h, out_w, 4) float32 (see prep.py)
    active_masks: np.ndarray    # (N, out_h, out_w) uint8
    content_boxes: Sequence[Box]          # per-sample active bounding boxes
    word_polygons: Sequence[List[Polygon]]   # co-transformed, out coords
    char_polygons: Sequence[List[Polygon]]
    # Device-extracted training crops (page_cropping.py on device);
    # empty arrays when cropping is disabled.
    crop_images: Optional[np.ndarray] = None    # (M, S, S, 3) uint8
    crop_labels: Optional[np.ndarray] = None    # (M, S, S, 4) float32
    crop_active: Optional[np.ndarray] = None    # (M, S, S) uint8
    crop_page_ids: Optional[np.ndarray] = None  # (M,) int32
    crop_windows: Optional[np.ndarray] = None   # (M, 2) int32 (up, left)
    # Real crop count: with keep_on_device the crop tensors stay PADDED
    # to a power of two on device (static compiled shapes) and rows
    # beyond num_crops are duplicates of row 0.
    num_crops: int = 0
    # Per-char gaussian heatmaps (char_heatmap engine semantics, rendered
    # ON DEVICE from the post-warp char quads); None unless requested.
    char_gaussian_maps: Optional[np.ndarray] = None  # (N, out_h, out_w) f32
    # Raw co-transformed char quads, (G, 4, 2) float64 per page — the
    # same geometry as char_polygons without the per-object overhead;
    # the region stream's hot host loops consume these.  None per page
    # only if a char polygon were not a quad (prep always emits quads).
    char_quads: Optional[Sequence[Optional[np.ndarray]]] = None
    # The adaptive-scaling output family (synth/region.py): stacked
    # region pages + char regression labels + region crops; None unless
    # a RegionStreamConfig was passed.
    text_regions: Optional[object] = None  # RegionBatchResult


def _char_gaussian_maps(char_polygons, out_shape, tile: int = 64,
                        keep_on_device: bool = False):
    """One device program: analytic gaussian bumps through each post-warp
    char quad (ops/region.batch_char_heatmaps) max-accumulated onto the
    page canvas (ops/glyph.accumulate_glyph_alpha).  The reference warps a
    sampled bump per char on host (char_heatmap/default.py); overlap
    neutralization stays with the host engine."""
    from ..ops.glyph import GlyphPlacements, accumulate_glyph_alpha
    from ..ops.region import batch_char_heatmaps

    n = len(char_polygons)
    quads = []
    rows = []
    for sid, polys in enumerate(char_polygons):
        for poly in polys:
            xy = poly.np_xy.astype(np.float64)
            up = float(np.floor(xy[:, 1].min()))
            left = float(np.floor(xy[:, 0].min()))
            h = xy[:, 1].max() - up + 1
            w = xy[:, 0].max() - left + 1
            if h < 2 or w < 2 or h > tile or w > tile:
                continue
            rel = xy - np.asarray([left, up])
            quads.append(rel)
            rows.append((len(quads) - 1, sid, int(up), int(left),
                         int(np.ceil(h)), int(np.ceil(w))))
    canvas = jnp.zeros((n,) + tuple(out_shape), dtype=jnp.float32)
    if not rows:
        return canvas if keep_on_device else np.asarray(canvas)
    quads_np = np.stack(quads)
    tiles = batch_char_heatmaps(quads_np, tile=tile)

    bucket = 64
    while bucket < len(rows):
        bucket *= 2
    pad = bucket - len(rows)

    def arr(vals, dtype):
        return jnp.asarray(np.asarray(
            list(vals) + [vals[0]] * pad if pad else list(vals), dtype=dtype
        ))

    placements = GlyphPlacements(
        glyph_ids=arr([r[0] for r in rows], np.int32),
        sample_ids=arr([r[1] for r in rows], np.int32),
        ups=arr([r[2] for r in rows], np.int32),
        lefts=arr([r[3] for r in rows], np.int32),
        dst_hs=arr([r[4] for r in rows], np.int32),
        dst_ws=arr([r[5] for r in rows], np.int32),
        src_hs=arr([float(r[4]) for r in rows], np.float32),
        src_ws=arr([float(r[5]) for r in rows], np.float32),
        colors=jnp.zeros((bucket, 3), jnp.float32),
        valids=arr([1.0] * len(rows), np.float32),
    )
    out = accumulate_glyph_alpha(canvas, tiles, placements, out_tile=tile)
    return out if keep_on_device else np.asarray(out)


class CropConfig(NamedTuple):
    """Device cropping knobs (page_cropping.py semantics: N random crops
    + filters; extraction runs as one device program over the warped
    stack, no full-page readback needed to sample windows)."""
    core_size: int
    num_per_page: int = 2
    text_ratio_min: float = 0.025
    active_ratio_min: float = 0.4
    retries: int = 10


def _sample_crop_windows(
    out_shape: Tuple[int, int],
    content_boxes: Sequence[Box],
    word_polygons: Sequence[List[Polygon]],
    crop: 'CropConfig',
    rng: RandomGenerator,
):
    """Per-page crop windows from ANALYTIC info only (content boxes +
    co-transformed word polygons): the text/active filters of
    page_cropping.py:87 evaluated on polygon bounding boxes instead of
    label rasters, so no device->host readback gates the sampling.

    ``active_ratio_min`` is enforced on the content-box BBOX — an upper
    bound on true raster coverage, so for strongly rotated/warped pages
    a crop the reference's raster filter would reject (true active ratio
    below the threshold) can still be emitted.  The text_ratio filter
    (word-polygon bboxes, tight) dominates in practice."""
    h, w = out_shape
    s = crop.core_size
    sample_ids: List[int] = []
    ups: List[int] = []
    lefts: List[int] = []
    for idx, (cbox, words) in enumerate(zip(content_boxes, word_polygons)):
        if h < s or w < s:
            continue
        boxes = []
        for poly in words:
            xy = poly.np_xy
            boxes.append((xy[:, 1].min(), xy[:, 1].max(),
                          xy[:, 0].min(), xy[:, 0].max()))
        boxes_np = np.asarray(boxes, dtype=np.float64) if boxes else None

        def window_ok(up: int, left: int) -> bool:
            if boxes_np is not None:
                iu = np.maximum(boxes_np[:, 0], up)
                id_ = np.minimum(boxes_np[:, 1], up + s - 1)
                il = np.maximum(boxes_np[:, 2], left)
                ir = np.minimum(boxes_np[:, 3], left + s - 1)
                area = (np.maximum(id_ - iu + 1, 0)
                        * np.maximum(ir - il + 1, 0)).sum()
                if area / (s * s) < crop.text_ratio_min:
                    return False
            elif crop.text_ratio_min > 0:
                return False
            au = max(cbox.up, up)
            ad = min(cbox.down, up + s - 1)
            al = max(cbox.left, left)
            ar = min(cbox.right, left + s - 1)
            active = max(ad - au + 1, 0) * max(ar - al + 1, 0)
            return active / (s * s) >= crop.active_ratio_min

        accepted = 0
        for _ in range(crop.num_per_page):
            placed = False
            for _ in range(crop.retries):
                up = int(rng.integers(0, h - s + 1))
                left = int(rng.integers(0, w - s + 1))
                if window_ok(up, left):
                    placed = True
                    break
            if not placed:
                # Centered-on-content fallback (the reference's center
                # crop), clamped to the canvas.
                up = int(np.clip((cbox.up + cbox.down) // 2 - s // 2,
                                 0, h - s))
                left = int(np.clip((cbox.left + cbox.right) // 2 - s // 2,
                                   0, w - s))
                if not window_ok(up, left):
                    continue
            sample_ids.append(idx)
            ups.append(up)
            lefts.append(left)
            accepted += 1
    return (np.asarray(sample_ids, dtype=np.int32),
            np.asarray(ups, dtype=np.int32),
            np.asarray(lefts, dtype=np.int32))


import functools


@functools.partial(jax.jit, static_argnames=('size',))
def _extract_crops_program(images, labels, active, sample_ids, ups, lefts,
                           size: int):
    """One device program: scan the crop table, dynamic-slice each window
    out of the warped page stack."""

    def body(_, row):
        sid, up, left = row
        img = jax.lax.dynamic_slice(
            images, (sid, up, left, 0), (1, size, size, images.shape[3])
        )[0]
        lab = jax.lax.dynamic_slice(
            labels, (sid, up, left, 0), (1, size, size, labels.shape[3])
        )[0]
        act = jax.lax.dynamic_slice(
            active, (sid, up, left), (1, size, size)
        )[0]
        return 0, (img, lab, act)

    _, (imgs, labs, acts) = jax.lax.scan(
        body, 0, (sample_ids, ups, lefts)
    )
    return imgs, labs, acts


@jax.jit
def _finish_program_const(stack, stretches, active):
    """Finish variant for all-affine batches: the local vertical stretch
    is a per-sample constant derived analytically from the matrices, so
    no dense maps ever materialize."""
    x = stack.astype(jnp.float32)
    stretch = stretches[:, None, None]
    x = x.at[..., 3 + TEXT_LINE_HEIGHT].multiply(stretch)
    x = x.at[..., 3 + CHAR_HEIGHT].multiply(stretch)
    gate = (active > 0.5).astype(jnp.float32)[..., None]
    x = x * gate
    images = jnp.clip(jnp.round(x[..., :3]), 0, 255).astype(jnp.uint8)
    return images, x[..., 3:], (active > 0.5).astype(jnp.uint8)


def _affine_stretches(plans) -> np.ndarray:
    """Per-sample constant vertical stretch of affine/nop plans: the
    inverse of how many source pixels one dst row step covers."""
    out = np.ones(len(plans), dtype=np.float32)
    for i, plan in enumerate(plans):
        if plan.matrix is None:
            continue
        mat3 = np.eye(3, dtype=np.float64)
        m = np.asarray(plan.matrix, dtype=np.float64)
        mat3[:m.shape[0]] = m
        inv = np.linalg.inv(mat3)
        step = float(np.hypot(inv[0, 1], inv[1, 1]))
        out[i] = 1.0 / max(step, 1e-3)
    return np.clip(out, 0.05, 20.0)


@jax.jit
def _finish_program(stack, map_ys, map_xs, active):
    """Height-channel correction by the warp's local vertical stretch.

    The backward field maps dst->src, so a dst step of 1 px covers
    ||d(src)/d(dst_y)|| source pixels; content rendered there stretched by
    the inverse.  Because the final resize is folded into the plans
    (rescale_plan_to), the stretch carries the resize ratio too — this is
    the device twin of the reference recomputing heights from warped point
    pairs and then rescaling them with the page.
    """
    x = stack.astype(jnp.float32)
    dmy = jnp.diff(map_ys, axis=1, append=map_ys[:, -1:, :])
    dmx = jnp.diff(map_xs, axis=1, append=map_xs[:, -1:, :])
    step = jnp.sqrt(dmy * dmy + dmx * dmx)
    stretch = jnp.clip(1.0 / jnp.maximum(step, 1e-3), 0.05, 20.0)

    x = x.at[..., 3 + TEXT_LINE_HEIGHT].multiply(stretch)
    x = x.at[..., 3 + CHAR_HEIGHT].multiply(stretch)

    # The warp extends its backward maps smoothly past the projected
    # border (tap-budget discipline); the active mask restores border
    # semantics outside the content region.
    gate = (active > 0.5).astype(jnp.float32)[..., None]
    x = x * gate
    images = jnp.clip(jnp.round(x[..., :3]), 0, 255).astype(jnp.uint8)
    labels = x[..., 3:]
    active_u8 = (active > 0.5).astype(jnp.uint8)
    return images, labels, active_u8


def synthesize_page_batch(
    pages: Sequence[HostPage],
    level: int,
    rng: RandomGenerator,
    key=None,
    out_shape: Optional[Tuple[int, int]] = None,
    enable_photometric: bool = True,
    enable_geometric: bool = True,
    placement_bucket: int = 1024,
    crop_config: Optional[CropConfig] = None,
    emit_char_gaussians: bool = False,
    region_config=None,
    keep_on_device: bool = False,
    timer=None,
) -> SynthBatchResult:
    """Run the device synthesis program over N host-prepped pages.

    ``out_shape`` (default: the page shape) is the STATIC output canvas;
    every randomized geometric draw folds its resize into the warp plan so
    one compiled program serves all batches.

    ``keep_on_device``: leave every raster output (pages, label stack,
    active masks, crops, region family) as DEVICE arrays — nothing
    round-trips to host except analytic metadata.  Training consumers
    hand these straight to synth_to_train_batch; the reference instead
    pickles full sample dicts across its process pool
    (vkit/utility/pool.py:162-184).

    ``timer``: optional utility.profiling.StepTimer; when set, each stage
    is wall-clocked and FORCED (a one-element fetch) at its end, so the
    per-stage numbers attribute true device time instead of async enqueue
    time.  Profiling therefore serializes the stage pipeline — leave it
    None in production.
    """
    from contextlib import nullcontext

    from ..mechanism.distortion.warp_plan import (
        nop_plan,
        plan_content_box,
        rescale_plan_to,
        warp_active_mask,
    )
    from ..utility import enable_compilation_cache, tune_host_allocator

    enable_compilation_cache()
    tune_host_allocator()

    measure = (timer.measure if timer is not None
               else (lambda name: nullcontext()))

    def sync(x):
        if timer is not None and x is not None:
            float(jnp.asarray(x[(0,) * getattr(x, 'ndim', 0)]))
        return x

    n = len(pages)
    assert n > 0
    height, width = pages[0].background.shape[:2]
    assert all(p.background.shape[:2] == (height, width) for p in pages)

    # 1. Assemble: glyph compositing, one program for the whole batch.
    with measure('assemble'):
        with measure('assemble.pack-host'):
            base = np.stack([p.background for p in pages])
            pack = global_atlas_pack()
            entries = []
            for sample_id, page in enumerate(pages):
                for layout, anchor, color, atlas in page.line_entries:
                    entries.append(
                        (layout, anchor, sample_id, color, atlas)
                    )
            if entries:
                placements, tiles, out_tile = pack_placements(
                    entries, pack, bucket=placement_bucket
                )
        with measure('assemble.glyphs'):
            if entries:
                assembled = composite_glyphs(base, tiles, placements,
                                             out_tile=out_tile)
            else:
                assembled = jnp.asarray(base)
            sync(assembled)

        # Above-text layers (non-text symbols, seal stamps) ride a second
        # scan program in z-order (page_assembler.py: text <- symbols <-
        # seals).
        with measure('assemble.overlays'):
            overlay = [
                (sample_id, entry)
                for sample_id, page in enumerate(pages)
                for entry in page.overlay_entries
            ]
            if overlay:
                assembled = _composite_overlays(assembled, overlay)
            sync(assembled)

    # 2. Photometric stage (policy-sampled, gated device rounds).
    if enable_photometric:
        with measure('photometric'):
            assembled = sync(batch_random_photometric_distort(
                assembled, level, rng, key=key
            ))

    # 3. Geometric stage: one dense warp moves image + labels together.
    # The final resize folds INTO each plan (rescale_plan_to), so every
    # sample's randomized warp lands on the one static output canvas in a
    # single resampling pass — one compiled program for every batch.
    out_shape = out_shape or (height, width)
    with measure('plan-host'):
        if enable_geometric:
            raw_plans = sample_geometric_plans(
                n, (height, width), level, rng
            )
        else:
            raw_plans = [nop_plan((height, width)) for _ in range(n)]
        plans = [rescale_plan_to(p, out_shape) for p in raw_plans]

    with measure('warp'):
        labels = np.stack([p.label_stack for p in pages])
        stack = jnp.concatenate(
            [assembled.astype(jnp.float32), jnp.asarray(labels)], axis=-1
        )
        warped, shapes, _, maps = batched_plan_warp(
            plans, stack, return_maps=True, mode='auto'
        )
        assert warped.shape[1:3] == out_shape
        sync(warped)

    with measure('active-host'):
        # uint8 upload (4x smaller than f32).
        active = np.zeros((n,) + out_shape, dtype=np.uint8)
        for idx, plan in enumerate(plans):
            active[idx] = warp_active_mask(plan).mat

    # 4. Height correction, one jitted program.
    with measure('finish'):
        if maps is None:
            images, label_stack, active_u8 = _finish_program_const(
                warped,
                jnp.asarray(_affine_stretches(plans)),
                jnp.asarray(active),
            )
        else:
            map_ys, map_xs = maps
            images, label_stack, active_u8 = _finish_program(
                warped,
                jnp.asarray(map_ys, dtype=jnp.float32),
                jnp.asarray(map_xs, dtype=jnp.float32),
                jnp.asarray(active),
            )
        sync(images)

    # Host: analytic polygon co-transform + content boxes (the reference's
    # corner-point trim folded into per-sample boxes; the rescaled plans
    # already map into output coordinates).  Content boxes come from the
    # plan geometry (plan_content_box, within +-1 px of the raster scan),
    # so nothing blocks on a device fetch.
    word_polygons: List[List[Polygon]] = []
    char_polygons: List[List[Polygon]] = []
    char_quads: List[np.ndarray] = []
    content_boxes: List[Box] = []
    with measure('polygons-host'):
        for plan, page in zip(plans, pages):
            # ONE map_points per page: the per-polygon loop paid a plan
            # evaluation per word/char (tens of thousands of tiny numpy
            # calls per batch).  Word vertex counts vary; chars are
            # always quads, so they also land in a raw (G, 4, 2) array
            # the region stream consumes without re-touching Polygon
            # objects.
            w_pts = [p.to_np_array() for p in page.word_polygons]
            c_pts = [p.to_np_array() for p in page.char_polygons]
            counts = [len(a) for a in w_pts] + [len(a) for a in c_pts]
            flat = (np.concatenate(w_pts + c_pts, axis=0)
                    if (w_pts or c_pts) else np.zeros((0, 2)))
            mapped = plan.map_points(flat)
            polys, at = [], 0
            for cnt in counts:
                polys.append(Polygon.from_np_array(mapped[at:at + cnt]))
                at += cnt
            word_polygons.append(polys[:len(w_pts)])
            char_polygons.append(polys[len(w_pts):])
            if all(len(a) == 4 for a in c_pts):
                quads = (mapped[-4 * len(c_pts):].reshape(-1, 4, 2)
                         if c_pts else np.zeros((0, 4, 2)))
            else:  # non-quad char outline (never in prep output today)
                quads = None
            char_quads.append(quads)
            content_boxes.append(plan_content_box(plan))

    with measure('fetch' if not keep_on_device else 'noop'):
        if keep_on_device:
            images_np, label_np, active_np = images, label_stack, active_u8
        else:
            images_np = np.asarray(images)
            label_np = np.asarray(label_stack)
            active_np = np.asarray(active_u8)

    gaussians = None
    if emit_char_gaussians:
        with measure('char-gaussians'):
            gaussians = sync(_char_gaussian_maps(
                char_polygons, out_shape, keep_on_device=keep_on_device
            ))

    crop_images = crop_labels = crop_active = crop_page_ids = None
    crop_windows = None
    num_crops = 0
    if crop_config is not None:
        crop_ctx = measure('crops')
        crop_ctx.__enter__()
        sids, c_ups, c_lefts = _sample_crop_windows(
            out_shape, content_boxes, word_polygons, crop_config, rng
        )
        if len(sids):
            count = num_crops = len(sids)
            bucket = 8
            while bucket < count:
                bucket *= 2
            pad = bucket - count

            def _pad(arr):
                return jnp.asarray(np.concatenate(
                    [arr, np.repeat(arr[:1], pad)]
                ))

            imgs, labs, acts = _extract_crops_program(
                images, label_stack, active_u8,
                _pad(sids), _pad(c_ups), _pad(c_lefts),
                size=crop_config.core_size,
            )
            if keep_on_device:
                crop_images, crop_labels, crop_active = imgs, labs, acts
                sync(crop_images)
            else:
                crop_images = np.asarray(imgs)[:count]
                crop_labels = np.asarray(labs)[:count]
                crop_active = np.asarray(acts)[:count]
            crop_page_ids = sids
            crop_windows = np.stack([c_ups, c_lefts], axis=1)
    if crop_config is not None:
        crop_ctx.__exit__(None, None, None)

    result = SynthBatchResult(
        images=images_np,
        label_stack=label_np,
        active_masks=active_np,
        content_boxes=content_boxes,
        word_polygons=word_polygons,
        char_polygons=char_polygons,
        crop_images=crop_images,
        crop_labels=crop_labels,
        crop_active=crop_active,
        crop_page_ids=crop_page_ids,
        crop_windows=crop_windows,
        char_gaussian_maps=gaussians,
        num_crops=num_crops,
        char_quads=char_quads,
    )
    if region_config is not None:
        from .region import stack_text_regions

        with measure('region'):
            result = result._replace(
                text_regions=stack_text_regions(
                    result, region_config, rng,
                    keep_on_device=keep_on_device, timer=timer,
                )
            )
    return result


def synthesize_stream(
    planner,
    batch_size: int,
    level: int,
    rng: RandomGenerator,
    num_batches: int,
    out_shape: Optional[Tuple[int, int]] = None,
    prefetch: int = 2,
    crop_config: Optional[CropConfig] = None,
    emit_char_gaussians: bool = False,
    region_config=None,
    keep_on_device: bool = False,
):
    """Generator of SynthBatchResults with host prep overlapped against
    device work: a background thread keeps up to ``prefetch`` prepared
    page batches queued (layout sampling, atlas text lines, label
    rasters) while the device program drains the previous batch — the
    prefetch-pump structure of parallel/prefetch.py applied to the synth
    pipeline (replaces the reference's inventory-backpressure pool,
    vkit/utility/pool.py:153-243, for this path)."""
    import queue
    import threading

    prep_queue: 'queue.Queue' = queue.Queue(maxsize=max(prefetch, 1))
    # Host sampling must stay deterministic given rng: draw per-batch
    # child seeds up front, in order.
    seeds = [int(rng.integers(0, 2**63 - 1)) for _ in range(num_batches)]
    level_rngs = [np.random.default_rng(seed) for seed in seeds]

    def producer():
        # A producer crash must SURFACE in the consumer, not strand it on
        # queue.get() forever (the reference's pool propagates worker
        # failures the same way, vkit/utility/pool.py:176-184).
        try:
            for batch_rng in level_rngs:
                prep_queue.put(planner.prepare_batch(batch_size, batch_rng))
        except BaseException as exc:  # noqa: BLE001 - relayed to consumer
            prep_queue.put(exc)
        else:
            prep_queue.put(None)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        idx = 0
        while True:
            pages = prep_queue.get()
            if pages is None:
                break
            if isinstance(pages, BaseException):
                raise pages
            yield synthesize_page_batch(
                pages, level=level, rng=level_rngs[idx],
                out_shape=out_shape, crop_config=crop_config,
                emit_char_gaussians=emit_char_gaussians,
                region_config=region_config,
                keep_on_device=keep_on_device,
            )
            idx += 1
    finally:
        thread.join(timeout=1.0)
