"""Smoke test of the synthesis path on one NVIDIA GPU.

    python chip_smoke.py               # phases (a)-(h) on one card
    python chip_smoke.py --four-cards  # dp=4 sharded generation only

Each phase prints one line; any failure raises and exits non-zero.  The
last line of a passing run is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Without a GPU (or outside a checkout of the repository) it exits
non-zero and prints no result line.

Phases (one card): (a) identity, (b) line primitives against float64
numpy at bench widths, (c) precision of the device twins against their
host twins, (d) warp routes against the per-element host warp, (e) the
batched RandomDistortion with labels, (f) ``synthesize_stream`` at the
bench width, (g) the reference production page, (h) the ``gpu``-marked
tests, in-process.
"""
import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SIDE = 640                  # bench page side
CANVAS = (704, 704)         # static letterbox canvas for randomized warps
PRODUCTION_PAGE = (2999, 2121)  # area ~2522^2, aspect sqrt(2) (SURVEY §2e)


class SmokeFailure(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


_START = time.perf_counter()


def say(tag, msg):
    print(f'[{tag}] {msg} [{time.perf_counter() - _START:.0f}s]', flush=True)


# ---------------------------------------------------------------------------
# (a) identity
# ---------------------------------------------------------------------------


def query_card():
    """``name, power.limit`` of each card, read before JAX opens one."""
    try:
        out = subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return None, f'nvidia-smi unavailable: {exc}'
    return out.stdout.strip().splitlines(), None


def phase_identity(card_lines, require_gpu=True):
    import jax

    devices = jax.devices()
    platform = devices[0].platform
    if require_gpu:
        check(platform == 'gpu',
              f'needs an NVIDIA GPU; JAX found platform {platform!r} '
              f'({len(devices)} device(s): {devices[0].device_kind})')
    sys.path.insert(0, str(REPO))
    import PIL

    from vkit_tpu.native import library_path, load_library

    prebuilt = library_path().exists()
    check(load_library() is not None,
          f'native geometry library failed to build/load '
          f'({library_path()})')
    say('a', f'platform={platform} device_kind={devices[0].device_kind} '
             f'count={len(devices)} card={card_lines} jax={jax.__version__} '
             f'pillow={PIL.__version__} native_geometry='
             f'{"loaded (build reused)" if prebuilt else "built+loaded"}')
    return devices


# ---------------------------------------------------------------------------
# (b) line primitives against float64 numpy, bench widths
# ---------------------------------------------------------------------------


def _timed(fn, *args, iters=5):
    import jax

    jax.block_until_ready(fn(*args))
    begin = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    return out, (time.perf_counter() - begin) / iters


def phase_primitives(batch=32, side=SIDE, channels=(3, 7), seed=0):
    """row_shift must match bit for bit; the banded interpolation within
    1e-3 on the 0-255 scale.  Host-clock times per call are printed as
    a rough guide; device times come from tools/gpu_profile.py."""
    import jax
    import jax.numpy as jnp

    from vkit_tpu.ops.warp_banded import banded_line_resample
    from vkit_tpu.ops.warp_mxu import row_shift

    rng = np.random.default_rng(seed)
    out_w = side + side // 2
    jp = -(-(side + side // 10) // 128) * 128
    shift = jax.jit(row_shift, static_argnums=(2,))
    banded = jax.jit(banded_line_resample, static_argnums=(3,))
    notes = []
    for c in channels:
        x = rng.random((batch, side, c, side), dtype=np.float32) * 255.0
        starts = rng.integers(-side // 2, side, (batch, side)).astype(np.int32)
        got, secs = _timed(shift, jnp.asarray(x), jnp.asarray(starts), out_w)
        idx = starts[:, :, None, None] + np.arange(out_w)
        ref = np.where(
            (idx >= 0) & (idx < side),
            np.take_along_axis(x, np.clip(idx, 0, side - 1), axis=-1), 0.0,
        )
        check(np.array_equal(np.asarray(got), ref),
              f'row_shift C={c}: not bit-exact')
        notes.append(f'row_shift C={c} bit-exact {secs * 1e3:.3f}ms')

        base = rng.integers(-8, side - side // 6,
                            (batch, -(-side // 8), jp // 128))
        p = np.arange(jp) % 128
        b_full = np.repeat(np.repeat(base, 8, axis=1)[:, :side], 128, axis=2)
        pos = (b_full + p + rng.uniform(0, 30, (batch, side, jp))).astype(
            np.float32)
        got, secs = _timed(banded, jnp.asarray(x), jnp.asarray(base),
                           jnp.asarray(pos), 32)
        xd = x.astype(np.float64)
        pd = pos.astype(np.float64)[:, :, None, :]
        i0 = np.floor(pd).astype(np.int64)
        frac = pd - i0

        def tap(i):
            v = np.take_along_axis(xd, np.clip(i, 0, side - 1), axis=-1)
            return np.where((i >= 0) & (i < side), v, 0.0)

        ref = tap(i0) * (1.0 - frac) + tap(i0 + 1) * frac
        err = float(np.abs(np.asarray(got, np.float64) - ref).max())
        check(err <= 1e-3, f'banded C={c}: max|err| {err:.2e} > 1e-3')
        notes.append(f'banded C={c} max|err|={err:.2e} {secs * 1e3:.3f}ms')
    say('b', f'primitives @{batch}x{side}^2: ' + '; '.join(notes))


# ---------------------------------------------------------------------------
# (c) precision: device twins against their host twins
# ---------------------------------------------------------------------------


def phase_precision(batch=4, side=SIDE, coord_shape=PRODUCTION_PAGE, seed=1):
    """Tolerances: resize and colour <= 1 LSB max and mean < 0.05 LSB
    (PARITY.md: sub-LSB MAE, rounding-boundary max); glyph compositing
    <= 1 LSB (tests/ops/test_glyph.py); coordinate-map upsampling
    <= 2e-3 px at production size (TF32 would be off by ~1 px); JPEG
    bit-exact."""
    import jax.numpy as jnp

    from tests.ops.test_glyph import np_composite
    from vkit_tpu.mechanism.batched import _upsample_node_maps
    from vkit_tpu.ops import color, colorspace_np
    from vkit_tpu.ops.glyph import build_placements, composite_glyphs
    from vkit_tpu.ops.jpeg_exact import (
        jpeg_roundtrip_exact,
        jpeg_roundtrip_exact_jnp,
    )
    from vkit_tpu.ops.effect import (
        _CHROMA_QTABLE,
        _LUMA_QTABLE,
        _quality_scaled_table,
    )
    from vkit_tpu.ops.resize import resize
    from vkit_tpu.ops.resize_taps import Interpolation, resize_np
    from vkit_tpu.ops.warp_banded import _node_grid, interp_node_weights

    rng = np.random.default_rng(seed)
    from scipy.ndimage import gaussian_filter

    smooth = gaussian_filter(
        rng.random((batch, side, side, 3)) * 255, sigma=(0, 2, 2, 0)
    ).astype(np.uint8)
    notes = []

    def lsb(got, want, what, max_bound=1, mean_bound=0.05):
        d = np.abs(np.asarray(got).astype(np.int64) - want.astype(np.int64))
        check(d.max() <= max_bound and d.mean() < mean_bound,
              f'{what}: max {d.max()} mean {d.mean():.4f} LSB')
        return f'{what} max={d.max()} mean={d.mean():.4f}'

    dst = (side + side // 10, side - side // 10)
    for interp in (Interpolation.LINEAR, Interpolation.CUBIC,
                   Interpolation.AREA):
        got = resize(jnp.asarray(smooth), dst, interp)
        want = np.stack([resize_np(im, dst, interp) for im in smooth])
        notes.append(lsb(got, want, f'resize-{interp.name.lower()}'))

    got = color.rgb_to_hsv_full(jnp.asarray(smooth))
    want = np.stack([colorspace_np.rgb_to_hsv_full(im) for im in smooth])
    d = np.abs(np.asarray(got).astype(int) - want.astype(int))
    d[..., 0] = np.minimum(d[..., 0], 256 - d[..., 0])   # cyclic hue
    check(d.max() <= 1 and d.mean() < 0.05,
          f'hsv: max {d.max()} mean {d.mean():.4f}')
    notes.append(f'rgb->hsv max={d.max()} mean={d.mean():.4f}')

    tiles = rng.random((64, 24, 24)).astype(np.float32)
    rows = []
    for sample_id in range(batch):
        for _ in range(40):
            rows.append({
                'glyph_id': int(rng.integers(0, 64)), 'sample_id': sample_id,
                'up': int(rng.integers(0, side - 32)),
                'left': int(rng.integers(0, side - 32)),
                'dst_h': int(rng.integers(16, 32)),
                'dst_w': int(rng.integers(16, 32)),
                'src_h': 24.0, 'src_w': 24.0,
                'color': rng.uniform(0, 255, 3).astype(np.float32),
            })
    got = composite_glyphs(jnp.asarray(smooth), tiles,
                           build_placements(rows, bucket=256), out_tile=32)
    notes.append(lsb(got, np_composite(smooth, tiles, rows, out_tile=32),
                     'glyphs', mean_bound=0.01))

    h, w = coord_shape
    ys, xs = _node_grid(h, 16), _node_grid(w, 16)
    gy, gx = np.meshgrid(ys.astype(np.float64), xs.astype(np.float64),
                         indexing='ij')
    bend = 6.0 * np.sin(gx / w * np.pi)
    coarse_y = np.stack([gy + bend, gy - bend])
    coarse_x = np.stack([gx + 0.3 * bend, gx * 0.98 + 7.0])
    w_y = interp_node_weights(h, ys)
    w_x = interp_node_weights(w, xs)
    my, mx = _upsample_node_maps(
        jnp.asarray(coarse_y, jnp.float32), jnp.asarray(coarse_x, jnp.float32),
        jnp.asarray(w_y), jnp.asarray(w_x),
    )
    w_y64 = w_y.astype(np.float64)
    w_x64 = w_x.astype(np.float64)
    ref_y = np.einsum('hr,nrc,wc->nhw', w_y64, coarse_y, w_x64,
                      optimize=True)
    ref_x = np.einsum('hr,nrc,wc->nhw', w_y64, coarse_x, w_x64,
                      optimize=True)
    err = max(float(np.abs(np.asarray(my) - ref_y).max()),
              float(np.abs(np.asarray(mx) - ref_x).max()))
    check(err <= 2e-3, f'coordinate upsample: max|err| {err:.2e} px')
    notes.append(f'coord-upsample@{h}x{w} max|err|={err:.1e}px')

    for quality in (95, 60, 30):
        luma = _quality_scaled_table(_LUMA_QTABLE, quality).astype(np.int32)
        chroma = _quality_scaled_table(_CHROMA_QTABLE, quality).astype(
            np.int32)
        got = np.asarray(jpeg_roundtrip_exact_jnp(
            jnp.asarray(smooth[0]), jnp.asarray(luma), jnp.asarray(chroma)))
        check(np.array_equal(got, jpeg_roundtrip_exact(smooth[0], quality)),
              f'jpeg q{quality}: not bit-exact')
    notes.append('jpeg q95/60/30 bit-exact')
    say('c', 'precision: ' + '; '.join(notes))


# ---------------------------------------------------------------------------
# (d) warp routes against the per-element host warp
# ---------------------------------------------------------------------------


def phase_warp_routes(batch=32, side=SIDE, canvas=CANVAS, seed=2):
    """Level-5 geometric policy draws through ``mode='auto'`` and
    ``mode='gather'``, against the per-element host warp with the bounds
    of tests/ops/test_dense_warp.py, pooled over the draws as PARITY.md's
    production-draw table pools them: banded (auto) interior (one 16-px
    node cell in) max <= 24 LSB, near-interior (4 px in) mean <= 1 LSB
    with at most 1e-3 of its pixels over 24 LSB (the edge band); gather
    <= 2 LSB on the near-interior.  Differences are per pixel, the max
    over channels.

    Matrix plans (affine, perspective) are compared with ``warp_image``.
    Lattice plans (camera, MLS, folds) reach the device as a coarse node
    field, so their host reference is ``remap_np`` over that same field;
    their distance from the exact per-cell ``warp_image`` is printed, not
    bounded (it is the node approximation, the same on any backend)."""
    import jax.numpy as jnp
    from scipy.ndimage import binary_erosion, gaussian_filter

    from vkit_tpu.element import Image
    from vkit_tpu.mechanism import batched
    from vkit_tpu.mechanism.batched_random import sample_geometric_plans
    from vkit_tpu.mechanism.distortion.warp_plan import (
        rescale_plan_to,
        warp_active_mask,
        warp_image,
    )
    from vkit_tpu.ops.warp import remap_np

    rng = np.random.default_rng(seed)
    img = gaussian_filter(rng.random((side, side, 3)) * 255,
                          sigma=(1.5, 1.5, 0)).astype(np.uint8)
    images = jnp.asarray(np.broadcast_to(img, (batch,) + img.shape))
    plans = [rescale_plan_to(p, canvas)
             for p in sample_geometric_plans(batch, (side, side), 5, rng)]
    outs, routes = {}, {}
    for mode in ('auto', 'gather'):
        res = batched.batched_plan_warp(plans, images, mode=mode,
                                        return_maps=True)
        outs[mode] = np.asarray(res[0])
        routes[mode] = dict(batched.LAST_ROUTES)
    map_ys, map_xs = (np.asarray(m) for m in res[3])

    stats = {'near_px': 0, 'auto_sum': 0, 'auto_over24': 0, 'auto_max': 0,
             'auto_worst_mean': 0.0, 'gather_max': 0,
             'node_worst_mean': 0.0, 'node_max': 0}
    kinds = {'matrix': 0, 'lattice': 0}
    for i, plan in enumerate(plans):
        exact = warp_image(plan, Image(mat=img)).mat
        hh, ww = exact.shape[:2]
        if plan.is_lattice:
            ref = remap_np(img, map_ys[i, :hh, :ww], map_xs[i, :hh, :ww])
            kinds['lattice'] += 1
        else:
            ref = exact
            kinds['matrix'] += 1
        cov = warp_active_mask(plan).mat.astype(bool)
        near = binary_erosion(cov, iterations=4)
        core = binary_erosion(cov, iterations=batched.COARSE_NODE_STEP)
        if not near.any():
            continue

        def diff(out, want):
            return np.abs(out[i, :hh, :ww].astype(np.int64)
                          - want.astype(np.int64)).max(axis=-1)

        d_auto, d_gather = diff(outs['auto'], ref), diff(outs['gather'], ref)
        stats['near_px'] += int(near.sum())
        stats['auto_sum'] += int(d_auto[near].sum())
        stats['auto_over24'] += int((d_auto[near] > 24).sum())
        stats['auto_worst_mean'] = max(stats['auto_worst_mean'],
                                       float(d_auto[near].mean()))
        stats['gather_max'] = max(stats['gather_max'],
                                  int(d_gather[near].max()))
        if core.any():
            stats['auto_max'] = max(stats['auto_max'], int(d_auto[core].max()))
        if plan.is_lattice and core.any():
            d_node = diff(outs['gather'], exact)
            stats['node_worst_mean'] = max(stats['node_worst_mean'],
                                           float(d_node[near].mean()))
            stats['node_max'] = max(stats['node_max'], int(d_node[core].max()))
    auto_mean = stats['auto_sum'] / max(stats['near_px'], 1)
    over24 = stats['auto_over24'] / max(stats['near_px'], 1)
    check(stats['auto_max'] <= 24 and auto_mean <= 1.0 and over24 <= 1e-3,
          f'auto route outside bounds: mean {auto_mean:.3f} '
          f'frac>24 {over24:.2e} {stats}')
    check(stats['gather_max'] <= 2, f'gather route outside bounds: {stats}')
    say('d', f'warp routes @{batch} level-5 draws {side}^2->{canvas} '
             f'({kinds}): auto interior max={stats["auto_max"]} '
             f'near-interior mean={auto_mean:.3f} (worst sample '
             f'{stats["auto_worst_mean"]:.3f}) frac>24={over24:.1e}; '
             f'gather max={stats["gather_max"]}; lattice node field vs '
             f'exact warp_image: worst sample mean='
             f'{stats["node_worst_mean"]:.3f} interior max='
             f'{stats["node_max"]}; routes auto={routes["auto"]} '
             f'gather={routes["gather"]}')


# ---------------------------------------------------------------------------
# (e) batched RandomDistortion with labels
# ---------------------------------------------------------------------------


def phase_random_distortion(batch=32, side=SIDE, canvas=CANVAS, seed=3):
    import jax
    import jax.numpy as jnp

    from vkit_tpu.mechanism import batched
    from vkit_tpu.mechanism.batched_random import (
        batch_random_photometric_distort,
        sample_geometric_plans,
    )
    from vkit_tpu.mechanism.distortion.warp_plan import (
        plan_content_box,
        rescale_plan_to,
        warp_active_mask,
    )

    rng = np.random.default_rng(seed)
    images = jnp.asarray(rng.integers(0, 256, (batch, side, side, 3),
                                      dtype=np.uint8))
    labels = np.empty((batch, side, side, 2), dtype=np.float32)
    labels[..., 0] = 1.0
    labels[..., 1] = rng.random((batch, side, side), dtype=np.float32)
    photo = batch_random_photometric_distort(
        images, 5, rng, key=jax.random.PRNGKey(seed))
    plans = [rescale_plan_to(p, canvas)
             for p in sample_geometric_plans(batch, (side, side), 5, rng)]
    stack = jnp.concatenate([photo.astype(jnp.float32), labels], axis=-1)
    out = np.asarray(batched.batched_plan_warp(plans, stack)[0])
    routes = dict(batched.LAST_ROUTES)
    check(out.shape == (batch,) + tuple(canvas) + (5,), f'shape {out.shape}')
    check(np.isfinite(out).all(), 'non-finite warped stack')
    corners = np.asarray([[0, 0], [side - 1, 0], [side - 1, side - 1]],
                         dtype=np.float64)
    inside = []
    for i, plan in enumerate(plans):
        box = plan_content_box(plan)
        core = np.zeros(canvas, dtype=bool)
        cov = warp_active_mask(plan).mat.astype(bool)
        core[:cov.shape[0], :cov.shape[1]] = cov
        mask = out[i, ..., 3][core]
        # The all-ones mask channel stays ~1 inside the coverage (its
        # boundary pixels blend with the border).
        inside.append(float(np.median(mask)))
        check(np.isfinite(plan.map_points(corners)).all(),
              'non-finite label points')
        check(box.up <= box.down and box.left <= box.right, 'empty box')
    check(min(inside) > 0.99, f'mask channel lost inside coverage: {inside}')
    check(0.0 <= out[..., :3].min() and out[..., :3].max() <= 255.0,
          'image channels out of range')
    say('e', f'RandomDistortion+labels @{batch}x{side}^2 level 5 -> '
             f'{out.shape}: ok, routes={routes}')


# ---------------------------------------------------------------------------
# (f), (g) end to end through synthesize_stream
# ---------------------------------------------------------------------------


def _planner(page_shape, assets_root):
    from tests.pipeline.fixtures import build_assets
    from vkit_tpu.synth import SynthPlanner, SynthPlannerConfig

    assets = build_assets(assets_root)
    selector = [{
        'type': 'selector', 'weight': 1,
        'config': {'image_folders': [assets['bg_image_folder']]},
    }]
    return SynthPlanner(SynthPlannerConfig(
        lexicon_collection_json=assets['lexicon_json'],
        font_collection_folder=assets['font_collection_folder'],
        char_sampler_configs=[{
            'type': 'corpus', 'weight': 1,
            'config': {'txt_files': [assets['corpus_txt']]},
        }],
        page_height=page_shape[0], page_width=page_shape[1],
        background_image_configs=selector,
        image_configs=selector,
        symbol_image_folders=[assets['symbol_image_folder']],
        enable_barcodes=True,
        enable_seal_impressions=True,
        enable_text_line_bounding_boxes=True,
    ))


def _run_stream(planner, batch, num_batches, rng, crop_size, page_shape):
    """Run the stream with the full output family; check every batch and
    return (seconds, counts)."""
    import jax

    from vkit_tpu.mechanism import batched
    from vkit_tpu.synth import CropConfig, synthesize_stream
    from vkit_tpu.synth.region import RegionStreamConfig

    counts = {'pages': 0, 'page_crops': 0, 'region_pages': 0,
              'region_crops': 0, 'routes': {}}
    begin = time.perf_counter()
    for result in synthesize_stream(
        planner, batch, 5, rng, num_batches=num_batches,
        crop_config=CropConfig(core_size=crop_size, num_per_page=2),
        region_config=RegionStreamConfig(num_crops_per_page=2),
        emit_char_gaussians=True, keep_on_device=True,
    ):
        for route, rows in batched.LAST_ROUTES.items():
            counts['routes'][route] = counts['routes'].get(route, 0) + rows
        jax.block_until_ready((result.images, result.label_stack))
        images = np.asarray(result.images)
        check(images.shape[:3] == (batch,) + tuple(page_shape),
              f'page batch shape {images.shape}')
        check(np.isfinite(np.asarray(result.label_stack)).all(),
              'non-finite labels')
        check(result.char_gaussian_maps is not None, 'no char gaussians')
        check(result.num_crops > 0, 'no page crops')
        tr = result.text_regions
        check(tr is not None and tr.num_pages > 0, 'no region pages')
        check(tr.num_crops > 0, 'no region crops')
        check(np.isfinite(np.asarray(tr.gaussian_maps)).all(),
              'non-finite region gaussians')
        counts['pages'] += images.shape[0]
        counts['page_crops'] += result.num_crops
        counts['region_pages'] += tr.num_pages
        counts['region_crops'] += tr.num_crops
    return time.perf_counter() - begin, counts


def _peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    peak = stats.get('peak_bytes_in_use')
    return 'not available' if peak is None else f'{peak / 2**30:.2f} GiB'


def phase_end_to_end(tag, page_shape, batch, num_batches, card, assets_root,
                     crop_size=512, seed=4):
    """One warm-up batch (compiles: set-up), then ``num_batches`` timed."""
    from vkit_tpu.utility import compile_count, compile_seconds

    planner = _planner(page_shape, assets_root)
    rng = np.random.default_rng(seed)
    c0, s0 = compile_count(), compile_seconds()
    setup_secs, _ = _run_stream(planner, batch, 1, rng, crop_size,
                                page_shape)
    c1, s1 = compile_count(), compile_seconds()
    secs, counts = _run_stream(planner, batch, num_batches, rng, crop_size,
                               page_shape)
    c2 = compile_count()
    say(tag, f'synthesize_stream {page_shape[0]}x{page_shape[1]} '
             f'batch={batch} x{num_batches}: '
             f'{counts["pages"] / secs:.3f} pages/s on {card} '
             f'({counts["pages"]} pages, {counts["page_crops"]} page crops, '
             f'{counts["region_pages"]} region pages, '
             f'{counts["region_crops"]} region crops, gaussians) | set-up: '
             f'{c1 - c0} compiles {s1 - s0:.1f}s compiling, first batch '
             f'{setup_secs:.1f}s | {c2 - c1} compiles in the timed window | '
             f'routes={counts["routes"]} | peak_bytes_in_use={_peak_bytes()}')


# ---------------------------------------------------------------------------
# (h) card-only tests
# ---------------------------------------------------------------------------


class _Outcomes:
    def __init__(self):
        self.counts = {'passed': 0, 'failed': 0, 'skipped': 0}

    def pytest_runtest_logreport(self, report):
        if report.when == 'call' or report.outcome != 'passed':
            self.counts[report.outcome] = self.counts.get(report.outcome, 0) + 1


def phase_gpu_tests(require_run=True):
    import pytest

    os.environ['VKIT_TEST_GPU'] = '1'
    outcomes = _Outcomes()
    rc = pytest.main(
        ['-q', '-m', 'gpu', '-p', 'no:cacheprovider', '-p', 'no:randomly',
         str(REPO / 'tests' / 'gpu')],
        plugins=[outcomes],
    )
    counts = outcomes.counts
    check(rc == 0 and counts['failed'] == 0, f'gpu tests failed: {counts}')
    if require_run:
        check(counts['passed'] > 0 and counts['skipped'] == 0,
              f'gpu tests did not all run: {counts}')
    say('h', f'pytest -m gpu: {counts}')
    return counts


# ---------------------------------------------------------------------------
# four cards: dp-sharded generation against one card
# ---------------------------------------------------------------------------


def phase_four_cards(devices, per_card=8, side=SIDE, seed=5):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec

    from __graft_entry__ import compose_fixture_pages
    from vkit_tpu.parallel import (
        make_mesh,
        sample_synthesis_params,
        shard_synthesis,
        synthesize_with_labels,
    )

    n_dev = len(devices)
    batch = per_card * n_dev
    rng = np.random.default_rng(seed)
    raw, labels = compose_fixture_pages(batch, side, rng)
    params, statics = sample_synthesis_params(rng, batch, side, side, 5)
    key = jax.random.PRNGKey(seed)

    mesh = make_mesh(n_dev, axis_names=('dp',))
    dp = NamedSharding(mesh, PartitionSpec('dp'))
    fn = jax.jit(shard_synthesis(mesh, params, statics, (side, side)))
    sharded = fn(
        jax.device_put(raw, dp), jax.device_put(labels, dp),
        jax.tree_util.tree_map(lambda x: jax.device_put(x, dp), params),
        key,
    )
    sharded = jax.block_until_ready(sharded)

    one = jax.jit(synthesize_with_labels, static_argnums=(4, 5))
    diffs = []
    for k in range(n_dev):
        sl = slice(k * per_card, (k + 1) * per_card)
        local = jax.device_put(
            (raw[sl], labels[sl],
             jax.tree_util.tree_map(lambda x: np.asarray(x)[sl], params),
             key),
            devices[0],
        )
        want = one(*local, statics, (side, side))
        for got_part, want_part in zip(sharded, want):
            g = np.asarray(got_part)[sl]
            w = np.asarray(want_part)
            diffs.append(float(np.abs(g.astype(np.float64) - w).max()))
            check(np.array_equal(g, w),
                  f'shard {k} differs from its one-card result: '
                  f'max|diff|={diffs[-1]}')
    say('4', f'dp={n_dev} sharded generation {batch}x{side}^2 '
             f'({per_card} per card): every shard equals its one-card '
             f'result (max|diff| {max(diffs)})')


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--four-cards', action='store_true',
                        help='run only the dp=4 sharded generation check')
    args = parser.parse_args(argv)

    card_lines, smi_error = query_card()
    try:
        devices = phase_identity(card_lines)
    except SmokeFailure as exc:
        print(f'chip_smoke: {exc}', file=sys.stderr)
        return 2
    if smi_error:
        print(f'chip_smoke: {smi_error}', file=sys.stderr)
        return 2
    for line in card_lines:
        print(line, flush=True)
    card = card_lines[0]

    from vkit_tpu.utility import enable_compilation_cache

    enable_compilation_cache()
    import tempfile

    with tempfile.TemporaryDirectory(prefix='vkit_smoke_') as tmp:
        if args.four_cards:
            check(len(devices) == 4, f'--four-cards needs 4 cards, '
                                     f'found {len(devices)}')
            phase_four_cards(devices)
        else:
            phase_primitives()
            phase_precision()
            phase_warp_routes()
            phase_random_distortion()
            phase_end_to_end('f', (SIDE, SIDE), 8, 3, card,
                             Path(tmp) / 'assets')
            phase_end_to_end('g', PRODUCTION_PAGE, 4, 2, card,
                             Path(tmp) / 'assets')
            phase_gpu_tests()
    print(json.dumps({'ok': True, 'device': {
        'platform': devices[0].platform,
        'kind': devices[0].device_kind,
        'count': len(devices),
    }}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
