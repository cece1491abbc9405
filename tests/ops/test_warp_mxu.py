"""Two-pass warp + the plain XLA line primitives (row shift, banded
two-neighbour resample) against float64 numpy references."""
import jax.numpy as jnp
import numpy as np
import pytest

from vkit_tpu.ops.warp import warp_affine_np
from vkit_tpu.ops.warp_banded import banded_line_resample
from vkit_tpu.ops.warp_mxu import row_shift, warp_affine_batch_mxu


def _row_shift_ref(x, starts, out_width, border_value):
    """Per-row loop: out[..., j] = x[..., s + j], border outside."""
    x = np.asarray(x, dtype=np.float64)
    out = np.full(x.shape[:-1] + (out_width,), border_value)
    width = x.shape[-1]
    for bi in range(x.shape[0]):
        for li in range(x.shape[1]):
            s = int(starts[bi, li])
            lo, hi = max(s, 0), min(s + out_width, width)
            if hi > lo:
                out[bi, li, ..., lo - s:hi - s] = x[bi, li, ..., lo:hi]
    return out


# (shape of x, start range, out_width, border): in-range starts as the
# padded planner emits them, negative starts, starts past the row end,
# and a (B, L, C, W) channel slab that shares one start per line.
_SHIFT_CASES = {
    'in_range': ((3, 64, 1536), (0, 512), 400, 0.0),
    'negative_starts': ((2, 48, 300), (-350, 0), 256, 7.0),
    'past_row': ((2, 48, 300), (200, 700), 256, -1.0),
    'channel_slab': ((3, 40, 3, 320), (-40, 200), 288, 0.5),
}


@pytest.mark.parametrize('case', sorted(_SHIFT_CASES))
def test_row_shift(case):
    shape, (lo, hi), ow, border = _SHIFT_CASES[case]
    rng = np.random.default_rng(0)
    x = rng.random(shape, dtype=np.float32)
    starts = rng.integers(lo, hi, shape[:2]).astype(np.int32)
    out = np.asarray(row_shift(jnp.asarray(x), jnp.asarray(starts), ow,
                               border_value=border))
    ref = _row_shift_ref(x, starts, ow, border)
    assert out.shape == ref.shape
    assert np.array_equal(out, ref.astype(np.float32))


def test_row_shift_large_batch():
    """Thousands of rows in one call (region flatten stacks), mixed-sign
    starts and a border fill: equal to the per-row reference."""
    rng = np.random.default_rng(1)
    b, l, c, iw, ow = 600, 128, 2, 300, 256
    x = rng.random((b, l, c, iw), dtype=np.float32)
    starts = rng.integers(-40, 200, (b, l)).astype(np.int32)
    out = np.asarray(row_shift(jnp.asarray(x), jnp.asarray(starts), ow,
                               border_value=0.5))
    rows = [0, 109, 599]
    ref = _row_shift_ref(x[rows], starts[rows], ow, 0.5)
    assert np.array_equal(out[rows], ref.astype(np.float32))


def _hat_sum_ref(x, base, pos, taps, border_value):
    """The ``taps``-long hat-weight sum from each block's integer base:
    out[j] = sum_t max(1 - |u - t|, 0) * src[b + p + t], u = pos - (b + p),
    for output j = 128 * blk + p and b the 8-line group's base."""
    n, l, c, width = x.shape
    jp = pos.shape[-1]
    xb = np.asarray(x, dtype=np.float64)
    out = np.zeros((n, l, c, jp))
    p = np.arange(128)
    for ni in range(n):
        for li in range(l):
            for blk in range(jp // 128):
                b = int(base[ni, li // 8, blk])
                u = pos[ni, li, blk * 128:(blk + 1) * 128] - (b + p)
                acc = np.zeros((c, 128))
                for t in range(taps):
                    w = np.maximum(1.0 - np.abs(u - t), 0.0)
                    idx = b + p + t
                    ok = (idx >= 0) & (idx < width)
                    src = np.where(
                        ok[None], xb[ni, li][:, np.clip(idx, 0, width - 1)],
                        border_value,
                    )
                    acc += src * w[None]
                out[ni, li, :, blk * 128:(blk + 1) * 128] = acc
    return out


@pytest.mark.parametrize('taps', [6, 32])
def test_banded_resample_equals_hat_sum(taps):
    """Wherever the planner's band guarantee holds (pos - (base + p) in
    [0, taps-2]) the two-neighbour interpolation equals the hat-weight
    sum, including blocks whose taps run off either end of the row."""
    rng = np.random.default_rng(taps)
    n, l, c, width, jp = 2, 12, 3, 200, 256
    x = rng.random((n, l, c, width)).astype(np.float32) * 255.0
    base = rng.integers(-60, width - 60, (n, -(-l // 8), jp // 128))
    p = np.arange(jp) % 128
    b_full = np.repeat(np.repeat(base, 8, axis=1)[:, :l], 128, axis=2)
    pos = (b_full + p[None, None, :]
           + rng.uniform(0.0, taps - 2, (n, l, jp))).astype(np.float32)
    out = np.asarray(banded_line_resample(
        jnp.asarray(x), jnp.asarray(base, jnp.int32), jnp.asarray(pos),
        taps, border_value=9.0,
    ))
    ref = _hat_sum_ref(x, base, pos.astype(np.float64), taps, 9.0)
    assert out.shape == (n, l, c, jp)
    np.testing.assert_allclose(out, ref, atol=2e-3, rtol=0)


def _fwd_mat(h, w, angle_deg, scale=1.0, tx=0.0, ty=0.0, shear=0.0):
    th = np.radians(angle_deg)
    cx, cy = (w - 1) / 2, (h - 1) / 2
    rot = np.array([
        [np.cos(th), -np.sin(th)],
        [np.sin(th), np.cos(th)],
    ]) * scale
    sh = np.array([[1.0, np.tan(np.radians(shear))], [0.0, 1.0]])
    lin = rot @ sh
    m = np.eye(3)
    m[:2, :2] = lin
    m[0, 2] = cx - lin[0, 0] * cx - lin[0, 1] * cy + tx
    m[1, 2] = cy - lin[1, 0] * cx - lin[1, 1] * cy + ty
    return m


@pytest.fixture(scope='module')
def smooth_image():
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    return gaussian_filter(
        rng.random((96, 96, 3)) * 255, sigma=2
    ).astype(np.float32)


def test_axis_aligned_exact(smooth_image):
    """Translate / scale: the decomposition IS direct bilinear."""
    h, w = smooth_image.shape[:2]
    mats = np.stack([
        _fwd_mat(h, w, 0),
        _fwd_mat(h, w, 0, tx=3.25, ty=-7.5),
        _fwd_mat(h, w, 0, scale=1.15),
    ])
    imgs = jnp.asarray(np.stack([smooth_image] * 3))
    out = np.asarray(warp_affine_batch_mxu(imgs, mats))
    for i in range(3):
        ref = warp_affine_np(smooth_image, mats[i], (h, w))
        assert np.abs(out[i] - ref).max() < 1e-3


def test_rotation_close(smooth_image):
    """Rotation/shear: sheared-footprint filter, interior within 1 LSB."""
    from vkit_tpu.ops.warp import affine_maps_np

    h, w = smooth_image.shape[:2]
    mats = np.stack([
        _fwd_mat(h, w, 17),
        _fwd_mat(h, w, -23, scale=0.9, shear=10, tx=5),
    ])
    imgs = jnp.asarray(np.stack([smooth_image] * 2))
    out = np.asarray(warp_affine_batch_mxu(imgs, mats))
    for i in range(2):
        ref = warp_affine_np(smooth_image, mats[i], (h, w))
        my, mx = affine_maps_np(mats[i], (h, w))
        interior = (my > 1) & (my < h - 2) & (mx > 1) & (mx < w - 2)
        diff = np.abs(out[i] - ref)
        assert diff[interior].max() < 1.0
        assert diff.mean() < 0.5


def test_uint8_roundtrip(smooth_image):
    h, w = smooth_image.shape[:2]
    mats = _fwd_mat(h, w, 9)[None]
    imgs = jnp.asarray(smooth_image.astype(np.uint8)[None])
    out = warp_affine_batch_mxu(imgs, mats)
    assert out.dtype == jnp.uint8
    assert out.shape == imgs.shape


def test_area_resize_upscale_matches_cv2():
    cv2 = pytest.importorskip('cv2')
    from vkit_tpu.ops.resize_taps import Interpolation, resize_np

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (40, 50, 3), dtype=np.uint8)
    for dsize in ((80, 100), (57, 73), (41, 51)):
        mine = resize_np(img, dsize, Interpolation.AREA)
        ref = cv2.resize(img, (dsize[1], dsize[0]), interpolation=cv2.INTER_AREA)
        assert np.abs(mine.astype(int) - ref.astype(int)).max() <= 1
