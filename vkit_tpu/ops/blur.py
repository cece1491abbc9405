"""Blur kernels: gaussian (separable), box, disk defocus, motion line.

Capability parity: cv2.GaussianBlur / cv2.filter2D at
vkit/mechanism/distortion/photometric/blur.py:46,65,118,181.  Border mode is
REFLECT_101 (cv2's default).  Convolutions run via lax depthwise conv.
"""
import functools
import math
from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np

from .common import expand_chw, round_u8


def gaussian_kernel1d(sigma: float, ksize: int) -> np.ndarray:
    """Matches cv2.getGaussianKernel (sigma<=0 derives from ksize)."""
    assert ksize % 2 == 1
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    xs = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    kernel = np.exp(-(xs**2) / (2 * sigma**2))
    return (kernel / kernel.sum()).astype(np.float32)


def disk_kernel(radius: int, alias_blur: float = 0.1) -> np.ndarray:
    """Anti-aliased disk (defocus) kernel, normalized.

    Mirrors the defocus construction at blur.py:79-129 (disk + small gaussian
    anti-alias).
    """
    if radius <= 8:
        length = np.arange(-8, 9)
        ksize = 3
    else:
        length = np.arange(-radius, radius + 1)
        ksize = 5
    xs, ys = np.meshgrid(length, length)
    aliased_disk = np.asarray((xs**2 + ys**2) <= radius**2, dtype=np.float64)
    aliased_disk /= aliased_disk.sum()
    # Gaussian anti-alias pass (host-side separable conv).
    g = gaussian_kernel1d(alias_blur, ksize).astype(np.float64)
    blurred = np.apply_along_axis(lambda row: np.convolve(row, g, mode='same'), 1, aliased_disk)
    blurred = np.apply_along_axis(lambda col: np.convolve(col, g, mode='same'), 0, blurred)
    return (blurred / blurred.sum()).astype(np.float32)


def motion_line_kernel(ksize: int, angle_deg: float) -> np.ndarray:
    """Line kernel of length ksize rotated by angle (degrees, CCW).

    Mirrors motion-blur kernel construction at blur.py:132-192 (horizontal
    line + cv2 rotation), built analytically: each kernel cell weights by its
    coverage of the rotated unit-thickness line segment.
    """
    assert ksize % 2 == 1
    center = (ksize - 1) / 2
    rad = math.radians(angle_deg)
    dx, dy = math.cos(rad), -math.sin(rad)
    ys, xs = np.mgrid[0:ksize, 0:ksize]
    rel_x = xs - center
    rel_y = ys - center
    # Distance from cell center to the infinite line, and projection along it.
    dist_perp = np.abs(rel_x * dy - rel_y * dx)
    proj = rel_x * dx + rel_y * dy
    half_len = ksize / 2.0
    kernel = np.where((dist_perp <= 0.5) & (np.abs(proj) <= half_len), 1.0, 0.0)
    if kernel.sum() == 0:
        kernel[int(center), int(center)] = 1.0
    return (kernel / kernel.sum()).astype(np.float32)


def _depthwise_conv2d(image4, kernel2d, padding='REFLECT'):
    """(N, H, W, C) * (kh, kw) depthwise correlate with reflect-101 border."""
    kh, kw = kernel2d.shape
    pad_h = kh // 2
    pad_w = kw // 2
    x = jnp.pad(
        image4,
        ((0, 0), (pad_h, pad_h), (pad_w, pad_w), (0, 0)),
        mode='reflect',
    )
    channels = image4.shape[-1]
    kernel = jnp.broadcast_to(
        jnp.asarray(kernel2d, dtype=jnp.float32)[:, :, None, None],
        (kh, kw, 1, channels),
    )
    return jax.lax.conv_general_dilated(
        x.astype(jnp.float32),
        kernel,
        window_strides=(1, 1),
        padding='VALID',
        dimension_numbers=('NHWC', 'HWIO', 'NHWC'),
        feature_group_count=channels,
        precision=lax.Precision.HIGHEST,
    )


def filter2d(image, kernel2d):
    """cv2.filter2D equivalent (correlate, reflect-101 border); dtype kept."""
    batched = image.ndim == 4
    if not batched:
        image3, had_c = expand_chw(image)
        image4 = image3[None]
    else:
        image4 = image
        had_c = True

    out = _depthwise_conv2d(image4, kernel2d)

    if image.dtype == jnp.uint8:
        out = round_u8(out)
    else:
        out = out.astype(image.dtype)
    if not batched:
        out = out[0]
        if not had_c:
            out = out[..., 0]
    return out


def gaussian_blur(image, sigma: float, ksize: int = 0):
    """cv2.GaussianBlur equivalent (separable)."""
    if ksize <= 0:
        # cv2 derives ksize from sigma when ksize==0.
        ksize = int(round(sigma * 3 * 2 + 1)) | 1
    k1 = gaussian_kernel1d(sigma, ksize)
    kernel = np.outer(k1, k1)
    return filter2d(image, kernel)


def box_blur(image, ksize: int):
    kernel = np.full((ksize, ksize), 1.0 / (ksize * ksize), dtype=np.float32)
    return filter2d(image, kernel)


# --------------------------------------------------------------------------
# Host (numpy/scipy) twins — per-element dynamic-shape path; the jnp path is
# for the batched static-shape device program (per-shape XLA compiles would
# dominate otherwise).
# --------------------------------------------------------------------------


def filter2d_np(image: np.ndarray, kernel2d: np.ndarray) -> np.ndarray:
    """Numpy twin of :func:`filter2d` (correlate, reflect-101 border)."""
    from scipy.ndimage import correlate

    kernel2d = np.asarray(kernel2d, dtype=np.float32)
    had_c = image.ndim == 3
    image3 = image if had_c else image[..., None]
    src = image3.astype(np.float32)
    out = np.empty_like(src)
    for ch in range(src.shape[-1]):
        # scipy 'mirror' == cv2 reflect-101.
        out[..., ch] = correlate(src[..., ch], kernel2d, mode='mirror')
    if not had_c:
        out = out[..., 0]
    if image.dtype == np.uint8:
        return np.clip(np.round(out), 0, 255).astype(np.uint8)
    return out.astype(image.dtype)


def gaussian_blur_np(image: np.ndarray, sigma: float, ksize: int = 0) -> np.ndarray:
    """Numpy twin of :func:`gaussian_blur` (separable, cv2 kernel taps)."""
    if ksize <= 0:
        ksize = int(round(sigma * 3 * 2 + 1)) | 1
    k1 = gaussian_kernel1d(sigma, ksize)
    return filter2d_np(image, np.outer(k1, k1))


def box_blur_np(image: np.ndarray, ksize: int) -> np.ndarray:
    kernel = np.full((ksize, ksize), 1.0 / (ksize * ksize), dtype=np.float32)
    return filter2d_np(image, kernel)
