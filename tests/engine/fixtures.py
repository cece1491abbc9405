"""Shared engine test fixtures: a FontCollection built over the DejaVu fonts
kept in tests/assets/fonts (license: tests/assets/fonts/LICENSE_DEJAVU)."""
import functools
import string
from pathlib import Path

from vkit_tpu.engine.font import (
    FontCollection,
    FontGlyphInfo,
    FontGlyphInfoCollection,
    FontMeta,
    FontMode,
)

ASCII_CHARS = sorted(set(string.ascii_letters + string.digits + string.punctuation))


@functools.lru_cache(maxsize=1)
def get_dejavu_font_files():
    ttf_dir = Path(__file__).resolve().parent.parent / 'assets' / 'fonts'
    files = sorted(str(f) for f in ttf_dir.glob('DejaVuSans*.ttf'))
    sans = [f for f in files if 'Mono' not in f and 'Display' not in f]
    mono = [f for f in files if 'Mono' in f]
    return sans, mono


def build_font_glyph_info_collection():
    return FontGlyphInfoCollection(
        font_glyph_infos=[
            FontGlyphInfo(
                tags=['ascii'],
                ascent_plus_pad_up_min_to_font_size_ratio=0.8,
                height_min_to_font_size_ratio=1.0,
                width_min_to_font_size_ratio=0.6,
            )
        ]
    )


@functools.lru_cache(maxsize=1)
def build_font_collection() -> FontCollection:
    sans, mono = get_dejavu_font_files()
    char_to_tags = {char: ['ascii'] for char in ASCII_CHARS}
    metas = [
        FontMeta(
            name='dejavu-sans',
            mode=FontMode.VTTC,
            char_to_tags=char_to_tags,
            font_files=sans,
            font_glyph_info_collection=build_font_glyph_info_collection(),
        ),
        FontMeta(
            name='dejavu-mono',
            mode=FontMode.VTTC,
            char_to_tags=char_to_tags,
            font_files=mono,
            font_glyph_info_collection=build_font_glyph_info_collection(),
        ),
    ]
    return FontCollection(font_metas=metas)
