"""Numerics only a GPU can show.

f32 contractions default to TF32 there (11 significant bits), so these
pin the explicit-precision sites and the plain line primitives at real
widths on the card.  Marked ``gpu``: they skip without one (see
tests/conftest.py); run them with ``VKIT_TEST_GPU=1 python -m pytest -m gpu
tests/gpu``.
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu


def test_coordinate_upsample_is_full_f32_at_page_width():
    """Absolute coordinates near 3000 px: TF32 would be off by ~1 px."""
    import jax.numpy as jnp

    from vkit_tpu.mechanism.batched import _upsample_node_maps
    from vkit_tpu.ops.warp_banded import _node_grid, interp_node_weights

    h, w = 2999, 2121
    ys, xs = _node_grid(h, 16), _node_grid(w, 16)
    gy, gx = np.meshgrid(ys.astype(np.float64), xs.astype(np.float64),
                         indexing='ij')
    coarse = np.stack([gy + 5.0 * np.sin(gx / w * np.pi), gx * 0.97 + 3.0])
    w_y, w_x = interp_node_weights(h, ys), interp_node_weights(w, xs)
    my, _ = _upsample_node_maps(
        jnp.asarray(coarse, jnp.float32), jnp.asarray(coarse, jnp.float32),
        jnp.asarray(w_y), jnp.asarray(w_x),
    )
    ref = np.einsum('hr,nrc,wc->nhw', w_y.astype(np.float64), coarse,
                    w_x.astype(np.float64), optimize=True)
    assert np.abs(np.asarray(my) - ref).max() <= 2e-3


def test_row_shift_bit_exact_on_card():
    import jax.numpy as jnp

    from vkit_tpu.ops.warp_mxu import row_shift

    rng = np.random.default_rng(0)
    x = rng.random((8, 640, 3, 640), dtype=np.float32)
    starts = rng.integers(-320, 640, (8, 640)).astype(np.int32)
    got = np.asarray(row_shift(jnp.asarray(x), jnp.asarray(starts), 1024,
                               border_value=2.0))
    idx = starts[:, :, None, None] + np.arange(1024)
    want = np.where(
        (idx >= 0) & (idx < 640),
        np.take_along_axis(x, np.clip(idx, 0, 639), axis=-1), 2.0,
    )
    assert np.array_equal(got, want)


def test_affine_warp_on_card_matches_host():
    """The two-pass warp (one-hot tap matmuls at HIGHEST) against the
    exact host warp: interior within 1 LSB at the bench width."""
    import jax.numpy as jnp
    from scipy.ndimage import gaussian_filter

    from vkit_tpu.ops.warp import affine_maps_np, warp_affine_np
    from vkit_tpu.ops.warp_mxu import warp_affine_batch_mxu

    rng = np.random.default_rng(1)
    img = gaussian_filter(rng.random((640, 640, 3)) * 255,
                          sigma=(2, 2, 0)).astype(np.float32)
    th = np.radians(17.0)
    c = 319.5
    mat = np.asarray([[np.cos(th), -np.sin(th), 0.0],
                      [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    mat[:2, 2] = [c - mat[0, 0] * c - mat[0, 1] * c,
                  c - mat[1, 0] * c - mat[1, 1] * c]
    out = np.asarray(warp_affine_batch_mxu(jnp.asarray(img[None]), mat[None]))
    ref = warp_affine_np(img, mat, (640, 640))
    my, mx = affine_maps_np(mat, (640, 640))
    interior = (my > 1) & (my < 638) & (mx > 1) & (mx < 638)
    assert np.abs(out[0] - ref)[interior].max() < 1.0


def test_jpeg_bit_exact_on_card():
    import jax.numpy as jnp

    from vkit_tpu.ops.effect import (
        _CHROMA_QTABLE,
        _LUMA_QTABLE,
        _quality_scaled_table,
    )
    from vkit_tpu.ops.jpeg_exact import (
        jpeg_roundtrip_exact,
        jpeg_roundtrip_exact_jnp,
    )

    img = np.random.default_rng(2).integers(0, 256, (640, 640, 3), np.uint8)
    luma = _quality_scaled_table(_LUMA_QTABLE, 50).astype(np.int32)
    chroma = _quality_scaled_table(_CHROMA_QTABLE, 50).astype(np.int32)
    got = np.asarray(jpeg_roundtrip_exact_jnp(
        jnp.asarray(img), jnp.asarray(luma), jnp.asarray(chroma)))
    assert np.array_equal(got, jpeg_roundtrip_exact(img, 50))
