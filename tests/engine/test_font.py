import numpy as np
import pytest

from tests.engine.fixtures import build_font_collection
from vkit_tpu.engine.font import (
    FontEngineRunConfig,
    FontEngineRunConfigGlyphSequence,
    font_freetype_default_engine_executor_factory,
    font_freetype_lcd_engine_executor_factory,
    font_freetype_monochrome_engine_executor_factory,
)


@pytest.fixture(scope='module')
def font_variant():
    collection = build_font_collection()
    return collection.font_metas[0].get_font_variant(0)


def run_engine(factory, font_variant, chars, height=32, width=300, **kwargs):
    executor = factory.create()
    run_config = FontEngineRunConfig(
        height=height,
        width=width,
        chars=chars,
        font_variant=font_variant,
        **kwargs,
    )
    return executor.run(run_config, np.random.default_rng(0))


def test_default_engine_renders_text(font_variant):
    text_line = run_engine(
        font_freetype_default_engine_executor_factory, font_variant, list('Hello World')
    )
    assert text_line is not None
    assert text_line.image.height == 32
    assert text_line.image.width <= 300
    # 10 non-space chars.
    assert len(text_line.char_boxes) == 10
    assert text_line.text == 'Hello World'
    assert text_line.is_hori
    # Ink present and mask aligns with dark pixels.
    assert text_line.mask.mat.sum() > 50
    ink = text_line.image.mat[text_line.mask.np_mask]
    assert ink.mean() < 250

    # Char boxes ordered left to right.
    lefts = [char_box.left for char_box in text_line.char_boxes]
    assert lefts == sorted(lefts)


def test_char_boxes_cover_ink(font_variant):
    text_line = run_engine(
        font_freetype_default_engine_executor_factory, font_variant, list('AB')
    )
    assert text_line is not None
    for char_box in text_line.char_boxes:
        sub = char_box.box.extract_mask(text_line.mask)
        assert sub.mat.any(), char_box.char


def test_split_and_polygons(font_variant):
    text_line = run_engine(
        font_freetype_default_engine_executor_factory, font_variant,
        list('foo bar'),
    )
    assert text_line is not None
    parts = text_line.split()
    assert len(parts) == 2
    assert parts[0].text == 'foo'
    assert parts[1].text == 'bar'

    polygon = text_line.to_polygon()
    assert polygon.num_points >= 4
    char_polygons = text_line.to_char_polygons(page_height=100, page_width=400)
    assert len(char_polygons) == len(text_line.char_boxes)


def test_vert_sequence(font_variant):
    text_line = run_engine(
        font_freetype_default_engine_executor_factory, font_variant,
        list('Vert'),
        height=300, width=32,
        glyph_sequence=FontEngineRunConfigGlyphSequence.VERT_DEFAULT,
    )
    assert text_line is not None
    assert not text_line.is_hori
    assert text_line.image.width == 32
    ups = [char_box.up for char_box in text_line.char_boxes]
    assert ups == sorted(ups)


def test_lcd_engine(font_variant):
    text_line = run_engine(
        font_freetype_lcd_engine_executor_factory, font_variant, list('LCD')
    )
    assert text_line is not None
    assert text_line.char_glyphs[0].image.mat.ndim == 3


def test_monochrome_engine(font_variant):
    text_line = run_engine(
        font_freetype_monochrome_engine_executor_factory, font_variant, list('Mono')
    )
    assert text_line is not None
    # Mono glyph alphas are 0/1 only.
    alphas = np.unique(text_line.char_glyphs[0].score_map.mat)
    assert set(np.round(alphas, 3)).issubset({0.0, 1.0})


def test_trim_long_text(font_variant):
    text_line = run_engine(
        font_freetype_default_engine_executor_factory, font_variant,
        list('This is a very long line of text that cannot possibly fit'),
        height=32, width=120,
    )
    # Either trimmed to fit or None.
    if text_line is not None:
        assert text_line.image.width <= 120
        assert len(text_line.char_boxes) < len('Thisisavery...')


def test_font_collection_filtering():
    collection = build_font_collection()
    metas = collection.filter_font_metas('Hi!')
    assert len(metas) == 2
    assert collection.filter_font_metas(['中']) == []


def test_atlas_pack_device_buffer_stable_shape():
    """The pack's device tile buffer must keep a STABLE shape while
    atlases grow (its shape is the glyph compositor's compiled signature
    — per-batch growth recompiled the program), adding
    new glyphs as in-place delta updates, and rebuild only on slab
    overflow or a tile-rung bump."""
    import numpy as np

    from vkit_tpu.engine.font.atlas import AtlasPack

    class FakeAtlas:
        def __init__(self, t=8):
            self.tiles = np.zeros((0, t, t), np.float32)

        def grow(self, k):
            t = self.tiles.shape[1]
            new = np.random.default_rng(len(self.tiles)).random(
                (k, t, t)).astype(np.float32)
            self.tiles = np.concatenate([self.tiles, new])

        def enlarge(self, t):
            old = self.tiles
            self.tiles = np.zeros((old.shape[0], t, t), np.float32)
            self.tiles[:, :old.shape[1], :old.shape[2]] = old

        def snapshot(self):
            return (self.tiles.shape[0], self.tiles.shape[1], self.tiles)

    pack = AtlasPack()
    a, b = FakeAtlas(), FakeAtlas()
    a.grow(3)
    b.grow(5)
    pack.global_id(a, 0)
    pack.global_id(b, 0)

    dev, resolve = pack.device_tiles_and_resolver()
    shape0 = dev.shape
    assert shape0[0] >= 8 and shape0[1] >= 8
    np.testing.assert_array_equal(
        np.asarray(dev[resolve((0, 2))])[:8, :8], a.tiles[2]
    )
    np.testing.assert_array_equal(
        np.asarray(dev[resolve((1, 4))])[:8, :8], b.tiles[4]
    )

    # Growth within the slab: same shape, delta content lands.
    a.grow(10)
    dev2, resolve2 = pack.device_tiles_and_resolver()
    assert dev2.shape == shape0
    np.testing.assert_array_equal(
        np.asarray(dev2[resolve2((0, 12))])[:8, :8], a.tiles[12]
    )
    # b's tiles are untouched by a's delta.
    np.testing.assert_array_equal(
        np.asarray(dev2[resolve2((1, 4))])[:8, :8], b.tiles[4]
    )

    # Slab overflow (past the 64-tile slab cap): rebuild, still correct.
    a.grow(80)
    dev3, resolve3 = pack.device_tiles_and_resolver()
    assert dev3.shape[1:] == shape0[1:]
    np.testing.assert_array_equal(
        np.asarray(dev3[resolve3((0, 90))])[:8, :8], a.tiles[90]
    )

    # Tile-rung bump: shape grows through the sparse rung ladder once.
    b.enlarge(20)
    b.grow(1)
    dev4, resolve4 = pack.device_tiles_and_resolver()
    assert dev4.shape[1] == 24  # rung above 20
    np.testing.assert_array_equal(
        np.asarray(dev4[resolve4((1, 5))])[:20, :20], b.tiles[5]
    )
