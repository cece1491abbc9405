"""Device-side colorspace conversions + histogram ops (jnp twins of
vkit_tpu/ops/colorspace_np.py).

Capability parity: cv2.cvtColor / cv2.equalizeHist usage at
vkit/element/image.py:794-812 and vkit/mechanism/distortion/photometric/
color.py:284.
"""
import jax
import jax.numpy as jnp
from jax import lax

from .common import round_u8, to_f32


def rgb_to_gray(image):
    x = to_f32(image)
    y = x[..., 0] * 0.299 + x[..., 1] * 0.587 + x[..., 2] * 0.114
    return round_u8(y) if image.dtype == jnp.uint8 else y


def rgb_to_hsv_full(image):
    rgb = to_f32(image)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = jnp.max(rgb, axis=-1)
    mn = jnp.min(rgb, axis=-1)
    diff = v - mn
    safe = jnp.where(diff == 0, 1.0, diff)
    s = jnp.where(v > 0, diff / jnp.where(v == 0, 1.0, v) * 255.0, 0.0)
    h = jnp.where(
        v == r,
        60.0 * (g - b) / safe,
        jnp.where(v == g, 120.0 + 60.0 * (b - r) / safe, 240.0 + 60.0 * (r - g) / safe),
    )
    h = jnp.where(diff == 0, 0.0, h)
    h = jnp.where(h < 0, h + 360.0, h)
    out = jnp.stack([h * (255.0 / 360.0), s, v], axis=-1)
    return round_u8(out) if image.dtype == jnp.uint8 else out


def hsv_full_to_rgb(image):
    h = to_f32(image[..., 0]) * (360.0 / 255.0)
    s = to_f32(image[..., 1]) / 255.0
    v = to_f32(image[..., 2])

    c = v * s
    hp = h / 60.0
    x = c * (1.0 - jnp.abs(jnp.mod(hp, 2.0) - 1.0))
    m = v - c

    sector = jnp.floor(hp).astype(jnp.int32) % 6
    z = jnp.zeros_like(c)
    r1 = jnp.select([sector == k for k in range(6)], [c, x, z, z, x, c])
    g1 = jnp.select([sector == k for k in range(6)], [x, c, c, x, z, z])
    b1 = jnp.select([sector == k for k in range(6)], [z, z, x, c, c, x])
    out = jnp.stack([r1 + m, g1 + m, b1 + m], axis=-1)
    return round_u8(out) if image.dtype == jnp.uint8 else out


def rgb_to_hsl_full(image):
    rgb = to_f32(image) / 255.0
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    mx = jnp.max(rgb, axis=-1)
    mn = jnp.min(rgb, axis=-1)
    diff = mx - mn
    summ = mx + mn
    lum = summ / 2.0
    denom = jnp.where(lum < 0.5, summ, 2.0 - summ)
    s = jnp.where(diff == 0, 0.0, diff / jnp.where(denom == 0, 1.0, denom))
    safe = jnp.where(diff == 0, 1.0, diff)
    h = jnp.where(
        mx == r,
        60.0 * (g - b) / safe,
        jnp.where(mx == g, 120.0 + 60.0 * (b - r) / safe, 240.0 + 60.0 * (r - g) / safe),
    )
    h = jnp.where(diff == 0, 0.0, h)
    h = jnp.where(h < 0, h + 360.0, h)
    out = jnp.stack([h * (255.0 / 360.0), s * 255.0, lum * 255.0], axis=-1)
    return round_u8(out) if image.dtype == jnp.uint8 else out


def hsl_full_to_rgb(image):
    h = to_f32(image[..., 0]) * (360.0 / 255.0)
    s = to_f32(image[..., 1]) / 255.0
    lum = to_f32(image[..., 2]) / 255.0

    c = (1.0 - jnp.abs(2.0 * lum - 1.0)) * s
    hp = h / 60.0
    x = c * (1.0 - jnp.abs(jnp.mod(hp, 2.0) - 1.0))
    m = lum - c / 2.0

    sector = jnp.floor(hp).astype(jnp.int32) % 6
    z = jnp.zeros_like(c)
    r1 = jnp.select([sector == k for k in range(6)], [c, x, z, z, x, c])
    g1 = jnp.select([sector == k for k in range(6)], [x, c, c, x, z, z])
    b1 = jnp.select([sector == k for k in range(6)], [z, z, x, c, c, x])
    out = jnp.stack([r1 + m, g1 + m, b1 + m], axis=-1) * 255.0
    return round_u8(out) if image.dtype == jnp.uint8 else out


def equalize_hist_batch(channels):
    """(B, H, W) uint8 -> (B, H, W), cv2.equalizeHist per plane.

    Both the 256-bin histogram and the LUT application run as
    NIBBLE-decomposed 16-wide batched contractions (v = 16*hi + lo;
    hist[a, b] via the one-hot outer product, lut[v] via
    sum_a oh_hi[., a] * (oh_lo @ L^T)[., a]), ~4 GMAC/plane, in place of
    a scatter-add bincount and the 256-wide one-hot contraction.  f32
    operands at full precision throughout: one-hots are {0, 1}, LUT
    entries are integers <= 255 and counts stay below 2^24, so every
    contraction here is exact.
    """
    b, h, w = channels.shape
    hw = h * w
    v = channels.astype(jnp.int32).reshape(b, hw)
    oh_hi = jax.nn.one_hot(v >> 4, 16, dtype=jnp.float32)
    oh_lo = jax.nn.one_hot(v & 15, 16, dtype=jnp.float32)

    hist = jnp.einsum(
        'npa,npb->nab', oh_hi, oh_lo, preferred_element_type=jnp.float32,
        precision=lax.Precision.HIGHEST,
    ).reshape(b, 256)
    cdf = jnp.cumsum(hist, axis=-1)
    # First nonzero cdf value.
    cdf_min = jnp.min(
        jnp.where(hist > 0, cdf, hw + 1), axis=-1, keepdims=True
    )
    denom = jnp.maximum(hw - cdf_min, 1)
    lut = jnp.clip(jnp.round((cdf - cdf_min) / denom * 255.0), 0, 255)

    m = jnp.einsum(
        'npb,nab->npa', oh_lo, lut.reshape(b, 16, 16),
        preferred_element_type=jnp.float32, precision=lax.Precision.HIGHEST,
    )
    mapped = (oh_hi * m).sum(axis=-1)
    mapped = mapped.reshape(b, h, w).astype(jnp.uint8)
    same = (cdf_min >= hw).reshape(b, 1, 1)  # Single-value plane: identity.
    return jnp.where(same, channels, mapped)


def equalize_hist(channel):
    """Per-channel histogram equalization (cv2.equalizeHist semantics)."""
    return equalize_hist_batch(channel[None])[0]
