"""Effect kernels: JPEG-quality simulation (block DCT), pixelation,
diamond-square fog field.

Capability parity: vkit/mechanism/distortion/photometric/effect.py:26-216
(cv.imencode/imdecode JPEG roundtrip, pixelation, fog).  JPEG is simulated
on-device: RGB→YCbCr, 4:2:0 chroma subsampling, 8×8 DCT (as batched
matmuls), quantization with libjpeg-style quality-scaled tables, inverse.
"""
import functools
import math

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np

from .common import round_u8, to_f32
from .resize import Interpolation, resize

# libjpeg base quantization tables (Annex K of the JPEG standard).
_LUMA_QTABLE = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], dtype=np.float64)

_CHROMA_QTABLE = np.array([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], dtype=np.float64)


def _quality_scaled_table(base: np.ndarray, quality: int) -> np.ndarray:
    quality = int(np.clip(quality, 1, 100))
    if quality < 50:
        scale = 5000 // quality    # INTEGER division (jcparam.c)
    else:
        scale = 200 - quality * 2
    table = (base.astype(np.int64) * scale + 50) // 100
    return np.clip(table, 1, 255)


@functools.lru_cache(maxsize=1)
def _dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix."""
    mat = np.zeros((8, 8))
    for k in range(8):
        for n in range(8):
            mat[k, n] = math.cos(math.pi * k * (2 * n + 1) / 16)
    mat[0] *= 1 / math.sqrt(2)
    return (mat * 0.5).astype(np.float32)


def _blockify(channel, block: int = 8):
    """(H, W) -> (H/8 * W/8, 8, 8); H, W must be multiples of 8."""
    height, width = channel.shape
    x = channel.reshape(height // block, block, width // block, block)
    return x.transpose(0, 2, 1, 3).reshape(-1, block, block)


def _unblockify(blocks, height: int, width: int, block: int = 8):
    x = blocks.reshape(height // block, width // block, block, block)
    return x.transpose(0, 2, 1, 3).reshape(height, width)


def _quantize_channel(channel, qtable):
    """8x8 DCT → quantize → dequantize → IDCT, all as batched matmuls.

    Transpose-free: the (H, W) channel is viewed as (H/8, 8, W/8, 8) and
    both DCT contractions act on the in-place 8-axes (the explicit
    blockify/unblockify transposes cost more HBM traffic than the DCTs).
    """
    height, width = channel.shape
    dct = jnp.asarray(_dct_matrix())
    y = (channel - 128.0).reshape(height // 8, 8, width // 8, 8)
    coeffs = jnp.einsum('ij,ajbk,lk->aibl', dct, y, dct,
                        precision=lax.Precision.HIGHEST)
    q = jnp.asarray(qtable, dtype=jnp.float32)[None, :, None, :]
    coeffs = jnp.round(coeffs / q) * q
    restored = jnp.einsum('ji,ajbk,kl->aibl', dct, coeffs, dct,
                          precision=lax.Precision.HIGHEST)
    return restored.reshape(height, width) + 128.0


def _pad_to_multiple(x, mult: int):
    height, width = x.shape[:2]
    pad_h = (-height) % mult
    pad_w = (-width) % mult
    if pad_h or pad_w:
        pad = ((0, pad_h), (0, pad_w)) + ((0, 0),) * (x.ndim - 2)
        x = jnp.pad(x, pad, mode='edge')
    return x, height, width


def jpeg_quality(image, quality: int):
    """Simulate a JPEG encode/decode roundtrip at the given quality.

    ``image``: uint8 RGB (H, W, 3) or grayscale (H, W).
    """
    luma_q = _quality_scaled_table(_LUMA_QTABLE, quality)
    chroma_q = _quality_scaled_table(_CHROMA_QTABLE, quality)

    if image.ndim == 2:
        x, height, width = _pad_to_multiple(to_f32(image), 8)
        y = _quantize_channel(x, luma_q)
        return round_u8(y[:height, :width])

    rgb = to_f32(image)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    y_p, height, width = _pad_to_multiple(y, 16)
    cb_p, _, _ = _pad_to_multiple(cb, 16)
    cr_p, _, _ = _pad_to_multiple(cr, 16)

    y_q = _quantize_channel(y_p, luma_q)

    # 4:2:0 chroma subsampling: 2x2 average, quantize, bilinear upsample.
    def chroma_roundtrip(c):
        ph, pw = c.shape
        sub = c.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))
        sub_q = _quantize_channel(sub, chroma_q)
        return resize(sub_q, (ph, pw), Interpolation.LINEAR)

    cb_q = chroma_roundtrip(cb_p)
    cr_q = chroma_roundtrip(cr_p)

    y_q = y_q[:height, :width]
    cb_q = cb_q[:height, :width] - 128.0
    cr_q = cr_q[:height, :width] - 128.0

    r2 = y_q + 1.402 * cr_q
    g2 = y_q - 0.344136 * cb_q - 0.714136 * cr_q
    b2 = y_q + 1.772 * cb_q
    return round_u8(jnp.stack([r2, g2, b2], axis=-1))


def jpeg_quality_np(image: np.ndarray, quality: int) -> np.ndarray:
    """Numpy twin of :func:`jpeg_quality` for the host per-element path
    (dynamic page shapes would force an XLA compile per shape)."""
    from .resize_taps import resize_np

    luma_q = _quality_scaled_table(_LUMA_QTABLE, quality)
    chroma_q = _quality_scaled_table(_CHROMA_QTABLE, quality)
    dct = _dct_matrix().astype(np.float64)

    def pad_to_multiple(x, mult):
        height, width = x.shape[:2]
        pad_h = (-height) % mult
        pad_w = (-width) % mult
        if pad_h or pad_w:
            x = np.pad(x, ((0, pad_h), (0, pad_w)), mode='edge')
        return x, height, width

    def quantize(channel, qtable):
        height, width = channel.shape
        blocks = (
            (channel - 128.0)
            .reshape(height // 8, 8, width // 8, 8)
            .transpose(0, 2, 1, 3)
        )
        coeffs = np.einsum('ij,hwjk,lk->hwil', dct, blocks, dct)
        coeffs = np.round(coeffs / qtable) * qtable
        restored = np.einsum('ji,hwjk,kl->hwil', dct, coeffs, dct)
        return (
            restored.transpose(0, 2, 1, 3).reshape(height, width) + 128.0
        )

    if image.ndim == 2:
        x, height, width = pad_to_multiple(image.astype(np.float64), 8)
        y = quantize(x, luma_q)[:height, :width]
        return np.clip(np.round(y), 0, 255).astype(np.uint8)

    rgb = image.astype(np.float64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    y_p, height, width = pad_to_multiple(y, 16)
    cb_p, _, _ = pad_to_multiple(cb, 16)
    cr_p, _, _ = pad_to_multiple(cr, 16)

    y_q = quantize(y_p, luma_q)

    def chroma_roundtrip(c):
        ph, pw = c.shape
        sub = c.reshape(ph // 2, 2, pw // 2, 2).mean(axis=(1, 3))
        sub_q = quantize(sub, chroma_q)
        return resize_np(
            sub_q.astype(np.float32), (ph, pw), Interpolation.LINEAR
        )

    cb_q = chroma_roundtrip(cb_p)[:height, :width] - 128.0
    cr_q = chroma_roundtrip(cr_p)[:height, :width] - 128.0
    y_q = y_q[:height, :width]

    r2 = y_q + 1.402 * cr_q
    g2 = y_q - 0.344136 * cb_q - 0.714136 * cr_q
    b2 = y_q + 1.772 * cb_q
    out = np.stack([r2, g2, b2], axis=-1)
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def pixelation(image, resized_shape):
    """Down then nearest-up (vkit effect.py:56-86)."""
    height, width = image.shape[:2]
    down = resize(image, resized_shape, Interpolation.LINEAR)
    return resize(down, (height, width), Interpolation.NEAREST)


def diamond_square_mask(key, size: int, roughness: float = 0.5):
    """Plasma-fractal heightfield in [0, 1] of shape (size, size).

    First-party equivalent of generate_diamond_square_mask
    (vkit .../effect.py:89-216), vectorized per scale: each octave adds
    bilinearly-upsampled uniform noise with geometrically decaying amplitude.
    ``size`` must be a power of two (or any size; grids are resized).
    """
    num_octaves = max(int(math.ceil(math.log2(max(size, 2)))), 1)
    acc = jnp.zeros((size, size), dtype=jnp.float32)
    amp = 1.0
    total = 0.0
    for octave in range(num_octaves):
        grid = 2 ** (octave + 1)
        sub_key = jax.random.fold_in(key, octave)
        noise = jax.random.uniform(sub_key, (grid, grid), dtype=jnp.float32)
        up = resize(noise, (size, size), Interpolation.LINEAR)
        acc = acc + amp * up
        total += amp
        amp *= roughness
    acc = acc / total
    lo = acc.min()
    hi = acc.max()
    return (acc - lo) / jnp.maximum(hi - lo, 1e-6)
