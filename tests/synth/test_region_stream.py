"""The adaptive-scaling output family: stacked region pages + char
regression labels + region crops emitted by the synth stream
(synth/region.py; behavioral spec vkit/pipeline/text_detection/
page_text_region.py:561-858 + page_text_region_label.py:443+)."""
import numpy as np
import pytest

from tests.pipeline.fixtures import build_assets
from vkit_tpu.synth import (
    RegionStreamConfig,
    SynthPlanner,
    SynthPlannerConfig,
    synthesize_page_batch,
    synthesize_stream,
)
from vkit_tpu.synth.region import char_regression_encodings


@pytest.fixture(scope='module')
def planner(tmp_path_factory):
    assets = build_assets(tmp_path_factory.mktemp('region_assets'))
    return SynthPlanner(SynthPlannerConfig(
        lexicon_collection_json=assets['lexicon_json'],
        font_collection_folder=assets['font_collection_folder'],
        char_sampler_configs=[{
            'type': 'corpus',
            'weight': 1,
            'config': {'txt_files': [assets['corpus_txt']]},
        }],
        page_height=320,
        page_width=320,
    ))


def test_char_regression_encodings_match_quad_geometry():
    """The vectorized encodings must agree with the per-object
    QuadGeometry math of the pipeline label step."""
    from vkit_tpu.pipeline.text_detection.page_text_region_label import (
        QuadGeometry,
    )

    rng = np.random.default_rng(0)
    corners = rng.uniform(0, 40, (16, 4, 2))
    # Make them proper clockwise quads around their centroid.
    corners = np.sort(corners, axis=1)
    quads = []
    for q in corners:
        cx, cy = q[:, 0].mean(), q[:, 1].mean()
        ang = np.arctan2(q[:, 1] - cy, q[:, 0] - cx)
        quads.append(q[np.argsort(ang)])
    quads = np.stack(quads)
    centers = quads.mean(axis=1)

    enc = char_regression_encodings(quads, centers)
    for i in range(len(quads)):
        geo = QuadGeometry(quads[i], centers[i, 0], centers[i, 1])
        np.testing.assert_allclose(enc.distances[i], geo.distances,
                                   rtol=1e-12)
        np.testing.assert_allclose(enc.angle_distributions[i],
                                   geo.angles / geo.angles.sum(),
                                   rtol=1e-12)
        assert bool(enc.valids[i]) == geo.valid
        np.testing.assert_allclose(
            enc.up_left_offsets_yx[i],
            np.asarray(geo.up_left_offset), rtol=1e-12,
        )


def test_stream_emits_stacked_regions_with_labels(planner):
    rng = np.random.default_rng(7)
    config = RegionStreamConfig(
        page_size=320, target_char_height=24,
        num_crops_per_page=1, crop_size=160,
    )
    saw_regions = False
    for result in synthesize_stream(
        planner, batch_size=2, level=3, rng=rng, num_batches=2,
        region_config=config,
    ):
        tr = result.text_regions
        if tr is None:
            continue
        saw_regions = True
        m, s, s2, c = tr.images.shape
        assert (s, s2, c) == (320, 320, 3) and m >= 1
        assert tr.active_masks.shape == (m, 320, 320)
        assert tr.gaussian_maps.shape == (m, 320, 320)
        # Stacked content exists and the gaussian labels fire on it.
        assert tr.active_masks.sum() > 0
        assert tr.gaussian_maps.max() > 0.3

        total_boxes = sum(len(b) for b in tr.region_boxes)
        total_chars = sum(len(p) for p in tr.char_polygons)
        assert total_boxes >= 1 and total_chars >= 1

        for page_idx in range(m):
            # Char polygons land inside the stacked canvas.
            for poly in tr.char_polygons[page_idx]:
                xy = poly.np_xy
                assert xy[:, 0].min() > -24 and xy[:, 0].max() < 344
                assert xy[:, 1].min() > -24 and xy[:, 1].max() < 344
            reg = tr.regression[page_idx]
            g = len(tr.char_polygons[page_idx])
            assert reg.corners_xy.shape == (g, 4, 2)
            assert reg.distances.shape == (g, 4)
            assert reg.angle_distributions.shape == (g, 4)
            if g:
                # Centroid label points are interior for the vast
                # majority of quads (the reference filters on `valid`).
                assert reg.valids.mean() > 0.8
                np.testing.assert_allclose(
                    reg.angle_distributions.sum(axis=1), 1.0, atol=1e-9
                )

        # Adaptive scaling: stacked char heights concentrate around the
        # target (flatten scale = target / median region char height).
        heights = []
        for polys in tr.char_polygons:
            for poly in polys:
                xy = poly.np_xy
                left = np.hypot(*(xy[3] - xy[0]))
                right = np.hypot(*(xy[2] - xy[1]))
                heights.append((left + right) / 2)
        assert heights
        median = float(np.median(heights))
        assert 12 <= median <= 40, median

        if tr.crop_images is not None:
            k = tr.crop_images.shape[0]
            assert tr.crop_images.shape == (k, 160, 160, 3)
            assert tr.crop_gaussians.shape == (k, 160, 160)
            assert tr.crop_active.shape == (k, 160, 160)
            assert tr.crop_page_ids.max() < m
    assert saw_regions, 'no batch produced text regions'


def test_region_pages_carry_region_content(planner):
    """Stacked pixels inside each region box must come from the source
    page (not the pinwheel background) wherever the mask is on."""
    rng = np.random.default_rng(11)
    pages = planner.prepare_batch(2, rng)
    result = synthesize_page_batch(
        pages, level=0, rng=rng,
        enable_photometric=False, enable_geometric=False,
        region_config=RegionStreamConfig(
            page_size=320, target_char_height=24
        ),
    )
    tr = result.text_regions
    assert tr is not None
    for page_idx, boxes in enumerate(tr.region_boxes):
        for box in boxes:
            win_active = tr.active_masks[
                page_idx, box.up:box.down + 1, box.left:box.right + 1
            ]
            win_img = tr.images[
                page_idx, box.up:box.down + 1, box.left:box.right + 1
            ]
            if win_active.sum() == 0:
                continue
            # The pinwheel background is saturated 255/0 per channel;
            # composited page content is not all-pinwheel.
            content = win_img[win_active > 0]
            assert not (
                ((content == 0) | (content == 255)).all()
            ), 'region window still shows only background'


def test_chunked_flatten_matches_single_chunk(planner, monkeypatch):
    """Forcing the multi-chunk flatten path (tiny per-chunk budget) must
    reproduce the single-chunk result exactly: an 8-page full-content
    batch stacks thousands of regions, and one whole-bucket program
    materialized a 25.8 GB intermediate — the chunked path is the
    production path, so pin its equivalence here."""
    from vkit_tpu.synth import region as region_mod
    from vkit_tpu.synth import synthesize_page_batch

    rng = np.random.default_rng(13)
    pages = planner.prepare_batch(2, rng)
    config = RegionStreamConfig(page_size=320, target_char_height=24)

    def run():
        res = synthesize_page_batch(
            pages, 3, np.random.default_rng(5),
            region_config=config,
        )
        return res.text_regions

    base = run()
    assert base is not None and base.num_pages >= 1
    # Force 64-row chunks (the minimum) so any bucket with > 64 regions
    # splits; verify at least one bucket actually chunked.
    monkeypatch.setattr(region_mod, '_CHUNK_BUDGET_BYTES', 1)
    assert region_mod._chunk_rows(128) == 64
    chunked = run()
    assert chunked is not None
    assert chunked.num_pages == base.num_pages
    np.testing.assert_array_equal(chunked.images, base.images)
    np.testing.assert_array_equal(chunked.active_masks, base.active_masks)
    np.testing.assert_allclose(
        chunked.gaussian_maps, base.gaussian_maps, atol=1e-5
    )
