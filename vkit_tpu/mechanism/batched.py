"""Batched device twins of the photometric distortion catalog.

The per-element API (mechanism/distortion/*) operates on one host Image at a
time, mirroring the reference's call shape (vkit/mechanism/distortion/
photometric/*).  This module is the throughput form: the SAME config classes
drive a traced program over an image batch (N, H, W, 3) uint8 on device —
per-sample parameters become arrays, data-dependent branches become masks,
and everything fuses under one jit.

Catalog coverage:
  color (10):  mean_shift, color_shift, brightness_shift, std_shift,
               boundary_equalization, histogram_equalization, complement,
               posterization, color_balance, channel_permutation
  noise (4):   gaussion_noise [sic], poisson_noise, impulse_noise,
               speckle_noise
  effect (3):  jpeg_quality, pixelation*, fog
  blur (5):    gaussian_blur, defocus_blur, motion_blur (host-built
               per-sample kernels, shared width), glass_blur (host-built
               permutation, one device gather), zoom_in_blur*
  streak (3): line_streak, rectangle_streak, ellipse_streak (masks built
               on host — cheap slicing — blended on device)
  (*) pixelation / zoom_in_blur require the shape-changing parameters to be
      shared across the batch (static shapes under jit).

Entry point: ``batch_distort_images(name, configs, images, key)``.
"""
import logging
from typing import Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax
import numpy as np

logger = logging.getLogger(__name__)

from ..ops import blur as blur_ops
from ..ops import color as color_ops
from ..ops import noise as noise_ops
from ..ops.effect import (
    _CHROMA_QTABLE,
    _LUMA_QTABLE,
    _quality_scaled_table,
)
from ..ops.common import to_f32
from ..ops.resize import Interpolation, resize
from .distortion.photometric.blur import estimate_gaussian_kernel_size
from .distortion.photometric.base import OutOfBoundBehavior

# ---------------------------------------------------------------------------
# Helpers.
# ---------------------------------------------------------------------------


def _per_sample(values, dtype=jnp.float32):
    """(N,) array broadcastable over (N, H, W, C).

    Accepts Python lists, numpy arrays, and traced jax values (the
    compiled dispatch passes per-sample params as jit arguments)."""
    if isinstance(values, jnp.ndarray):
        arr = values.astype(dtype)
    else:
        arr = jnp.asarray(np.asarray(values), dtype=dtype)
    return arr[:, None, None, None]


def _finish(x, oob: OutOfBoundBehavior = OutOfBoundBehavior.CLIP):
    x = jnp.round(x)
    if oob == OutOfBoundBehavior.CYCLE:
        return jnp.mod(x, 256.0).astype(jnp.uint8)
    return jnp.clip(x, 0, 255).astype(jnp.uint8)


def _apply_channels(images, new_channels, channels):
    if channels is None:
        return new_channels
    return images.at[..., jnp.asarray(list(channels))].set(new_channels)


def _select_channels(images, channels):
    if channels is None:
        return images
    return images[..., jnp.asarray(list(channels))]


# ---------------------------------------------------------------------------
# Color.
# ---------------------------------------------------------------------------


def batched_mean_shift(
    images,
    deltas,
    thresholds=None,
    channels: Optional[Sequence[int]] = None,
    oob_behavior: OutOfBoundBehavior = OutOfBoundBehavior.CLIP,
):
    x = _select_channels(images, channels).astype(jnp.float32)
    d = _per_sample(deltas)
    if thresholds is None:
        x = x + d
    else:
        t = _per_sample(thresholds)
        # delta > 0 shifts dark pixels up; delta <= 0 shifts bright down
        # (branch-free form of mean_shift_mat's gate).
        gate = jnp.where(d > 0, x <= t, t <= x)
        x = jnp.where(gate, x + d, x)
    return _apply_channels(images, _finish(x, oob_behavior), channels)


def batched_color_shift(images, deltas):
    hsv = color_ops.rgb_to_hsv_full(images).astype(jnp.float32)
    h = jnp.mod(hsv[..., 0] + _per_sample(deltas)[..., 0], 256.0)
    hsv = jnp.concatenate([h[..., None], hsv[..., 1:]], axis=-1)
    return color_ops.hsv_full_to_rgb(_finish(hsv, OutOfBoundBehavior.CYCLE))


def batched_brightness_shift(images, deltas, use_hsv: bool = False):
    if use_hsv:
        inter = color_ops.rgb_to_hsv_full(images).astype(jnp.float32)
    else:
        inter = color_ops.rgb_to_hsl_full(images).astype(jnp.float32)
    v = jnp.clip(inter[..., 2] + _per_sample(deltas)[..., 0], 0, 255)
    inter = jnp.concatenate([inter[..., :2], v[..., None]], axis=-1)
    inter = _finish(inter)
    if use_hsv:
        return color_ops.hsv_full_to_rgb(inter)
    return color_ops.hsl_full_to_rgb(inter)


def batched_std_shift(images, scales, channels: Optional[Sequence[int]] = None):
    x = _select_channels(images, channels).astype(jnp.float32)
    mean = x.mean(axis=(1, 2), keepdims=True)
    s = _per_sample(scales)
    x = x * s - mean * (s - 1.0)
    return _apply_channels(images, _finish(x), channels)


def batched_boundary_equalization(
    images, channels: Optional[Sequence[int]] = None
):
    x = _select_channels(images, channels).astype(jnp.float32)
    lo = x.min(axis=(1, 2), keepdims=True)
    hi = x.max(axis=(1, 2), keepdims=True)
    delta = hi - lo
    stretched = jnp.where(
        delta > 0, (x - lo) * (255.0 / jnp.maximum(delta, 1e-6)), x
    )
    return _apply_channels(images, _finish(stretched), channels)


def batched_histogram_equalization(
    images, channels: Optional[Sequence[int]] = None
):
    x = _select_channels(images, channels)
    n, h, w, c = x.shape
    flat = x.transpose(0, 3, 1, 2).reshape(n * c, h, w)
    eq = color_ops.equalize_hist_batch(flat)
    eq = eq.reshape(n, c, h, w).transpose(0, 2, 3, 1)
    return _apply_channels(images, eq, channels)


def batched_complement(
    images,
    thresholds=None,
    enable_threshold_ltes=False,
    channels: Optional[Sequence[int]] = None,
):
    x = _select_channels(images, channels).astype(jnp.float32)
    if thresholds is None:
        out = 255.0 - x
    else:
        t = _per_sample(thresholds)
        if isinstance(enable_threshold_ltes, (jnp.ndarray, np.ndarray)):
            lte = _per_sample(enable_threshold_ltes, dtype=jnp.bool_)
        else:
            lte = _per_sample(
                np.broadcast_to(
                    np.asarray(enable_threshold_ltes, dtype=bool),
                    (x.shape[0],)
                ),
                dtype=jnp.bool_,
            )
        gate = jnp.where(lte, x <= t, t <= x)
        out = jnp.where(gate, 255.0 - x, x)
    return _apply_channels(images, _finish(out), channels)


def batched_posterization(
    images, num_bits, channels: Optional[Sequence[int]] = None
):
    x = _select_channels(images, channels).astype(jnp.int32)
    bits = jnp.asarray(num_bits, dtype=jnp.int32)[:, None, None, None]
    keep = jnp.left_shift(jnp.right_shift(255, bits), bits)
    out = jnp.bitwise_and(x, keep).astype(jnp.uint8)
    return _apply_channels(images, out, channels)


def batched_color_balance(images, ratios):
    gray = color_ops.rgb_to_gray(images.astype(jnp.float32))[..., None]
    r = _per_sample(ratios)
    out = (1.0 - r) * gray + r * images.astype(jnp.float32)
    return _finish(out)


def batched_channel_permutation(images, perms):
    """``perms``: (N, C) int — out channel c reads in channel perms[n, c]."""
    perms = jnp.asarray(perms, dtype=jnp.int32)
    n, c = perms.shape
    onehot = jax.nn.one_hot(perms, c, dtype=jnp.float32)   # (N, C_out, C_in)
    out = jnp.einsum(
        'nhwc,nkc->nhwk', images.astype(jnp.float32), onehot,
        preferred_element_type=jnp.float32, precision=lax.Precision.HIGHEST,
    )
    return jnp.round(out).astype(jnp.uint8)


# ---------------------------------------------------------------------------
# Noise (jax PRNG; key is folded per sample inside the ops).
# ---------------------------------------------------------------------------


def batched_gaussion_noise(images, stds, key):
    noise = jax.random.normal(key, images.shape, dtype=jnp.float32)
    out = images.astype(jnp.float32) + noise * _per_sample(stds)
    return _finish(out)


def batched_poisson_noise(images, key):
    """Poisson(pixel) noise without jax.random.poisson's rejection
    while-loop: EXACT CDF inversion for
    lambda < 16 (32 incremental terms, one fused elementwise chain) and
    the standard normal approximation above (error O(1/sqrt(16)), well
    under the quantization step there).  Distributional parity, like the
    reference's rng-consuming ops."""
    lam = images.astype(jnp.float32)
    k1, k2 = jax.random.split(key)
    u = jax.random.uniform(k1, lam.shape, dtype=jnp.float32)
    lam_s = jnp.minimum(lam, 16.0)
    p = jnp.exp(-lam_s)
    c = p
    count = (u > c).astype(jnp.float32)
    for k in range(1, 32):
        p = p * (lam_s / k)
        c = c + p
        count = count + (u > c)
    z = jax.random.normal(k2, lam.shape, dtype=jnp.float32)
    approx = jnp.round(lam + jnp.sqrt(lam) * z)
    out = jnp.where(lam < 16.0, count, approx)
    return _finish(out)


def batched_impulse_noise(images, prob_salts, prob_peppers, key):
    u = jax.random.uniform(key, images.shape[:3])[..., None]
    ps = _per_sample(prob_salts)
    pp = _per_sample(prob_peppers)
    salt = u < ps
    pepper = (u >= ps) & (u < ps + pp)
    out = jnp.where(salt, jnp.uint8(255), images)
    return jnp.where(pepper, jnp.uint8(0), out)


def batched_speckle_noise(images, stds, key):
    noise = jax.random.normal(key, images.shape, dtype=jnp.float32)
    out = images.astype(jnp.float32) * (1.0 + noise * _per_sample(stds))
    return _finish(out)


# ---------------------------------------------------------------------------
# Effect.
# ---------------------------------------------------------------------------


def batched_jpeg_quality(images, qualities):
    """Per-sample qualities -> per-sample quant tables (host) -> the
    BIT-EXACT integer libjpeg pipeline (ops/jpeg_exact.py, int32)."""
    from ..ops.jpeg_exact import jpeg_roundtrip_exact_jnp

    luma = jnp.asarray(np.stack([
        _quality_scaled_table(_LUMA_QTABLE, int(q)) for q in np.asarray(qualities)
    ]).astype(np.int32))
    chroma = jnp.asarray(np.stack([
        _quality_scaled_table(_CHROMA_QTABLE, int(q)) for q in np.asarray(qualities)
    ]).astype(np.int32))
    # BGR-compat: the reference encodes its RGB mats through cv.imencode,
    # which reads them as BGR; run the codec on reversed channels.
    out = jax.vmap(jpeg_roundtrip_exact_jnp)(
        images[..., ::-1], luma, chroma
    )
    return out[..., ::-1]


def batched_fog(
    images,
    roughnesses,
    key,
    fog_rgb=(226, 238, 234),
    ratio_maxs=1.0,
    ratio_mins=0.0,
):
    from ..ops.effect import diamond_square_mask

    n, h, w = images.shape[:3]
    size = int(2 ** np.ceil(np.log2(max(h, w))))
    roughnesses = jnp.broadcast_to(
        jnp.asarray(roughnesses, dtype=jnp.float32), (n,)
    )
    keys = jax.random.split(key, n)
    masks = jax.vmap(
        lambda k, r: diamond_square_mask(k, size, r)
    )(keys, roughnesses)[:, :h, :w]

    lo = masks.min(axis=(1, 2), keepdims=True)
    hi = masks.max(axis=(1, 2), keepdims=True)
    masks = (masks - lo) / jnp.maximum(hi - lo, 1e-6)
    rmax = jnp.broadcast_to(jnp.asarray(ratio_maxs, jnp.float32), (n,))
    rmin = jnp.broadcast_to(jnp.asarray(ratio_mins, jnp.float32), (n,))
    masks = masks * (rmax - rmin)[:, None, None] + rmin[:, None, None]
    masks = masks[..., None]

    fog_mat = jnp.asarray(fog_rgb, dtype=jnp.float32)
    if fog_mat.ndim == 2:          # per-sample colors (N, 3)
        fog_mat = fog_mat[:, None, None, :]
    out = (1.0 - masks) * images.astype(jnp.float32) + masks * fog_mat
    return _finish(out)


# ---------------------------------------------------------------------------
# Blur (host-built per-sample kernels, shared width; vmapped conv).
# ---------------------------------------------------------------------------


# Shared blur-kernel widths: the padded width is a compiled-program
# static, and batch-max padding drew a fresh width (hence a fresh XLA
# program) nearly every randomized-policy batch.  A sparse odd ladder
# keeps the compile set tiny; extra taps are zeros (a few ms of conv).
_KERNEL_WIDTH_LADDER = (5, 9, 17, 33, 65)


def _padded_kernels(kernels):
    """Pad per-sample 2D kernels to a shared odd LADDER width."""
    ksize = max(k.shape[0] for k in kernels)
    if ksize % 2 == 0:
        ksize += 1
    for q in _KERNEL_WIDTH_LADDER:
        if ksize <= q:
            ksize = q
            break
    out = np.zeros((len(kernels), ksize, ksize), dtype=np.float32)
    for idx, k in enumerate(kernels):
        off_y = (ksize - k.shape[0]) // 2
        off_x = (ksize - k.shape[1]) // 2
        out[idx, off_y:off_y + k.shape[0], off_x:off_x + k.shape[1]] = k
    return jnp.asarray(out)


def _batched_filter2d(images, kernels):
    return jax.vmap(blur_ops.filter2d)(images, kernels)


def batched_gaussian_blur(images, sigmas):
    kernels = []
    for sigma in np.asarray(sigmas):
        ksize = estimate_gaussian_kernel_size(float(sigma))
        k1 = blur_ops.gaussian_kernel1d(float(sigma), ksize)
        kernels.append(np.outer(k1, k1))
    return _batched_filter2d(images, _padded_kernels(kernels))


def batched_defocus_blur(images, radii):
    kernels = []
    for radius in np.asarray(radii):
        radius = int(radius)
        size = 2 * radius + 1
        coords = np.arange(size) - radius
        xs, ys = np.meshgrid(coords, coords)
        kernel = ((xs**2 + ys**2) <= radius**2).astype(np.float32)
        kernels.append(kernel / kernel.sum())
    return _batched_filter2d(images, _padded_kernels(kernels))


def batched_motion_blur(images, radii, angles):
    kernels = []
    for radius, angle in zip(np.asarray(radii), np.asarray(angles)):
        ksize = 2 * int(radius) + 1
        kernel = blur_ops.motion_line_kernel(ksize, -(float(angle) % 360))
        kernels.append(kernel / max(kernel.sum(), 1e-6))
    return _batched_filter2d(images, _padded_kernels(kernels))


def batched_glass_blur(images, sigmas, deltas, loops, rng):
    """Gaussian blur + the iterated random pixel swaps, batched.

    The swap permutation is built on the host with the SAME routine as the
    per-element path (numpy rng), then applied on device as one flat
    nearest gather; one batched gather replaces per-image host
    application.
    """
    from .distortion.photometric.blur import (
        build_glass_blur_permutation,
        estimate_gaussian_kernel_size,
    )

    n, h, w = images.shape[:3]
    blurred = batched_gaussian_blur(images, sigmas)

    flat_idx = np.empty((n, h, w), dtype=np.int32)
    for i in range(n):
        pos_y, pos_x = build_glass_blur_permutation(
            (h, w), int(deltas[i]), int(loops[i]), rng
        )
        flat_idx[i] = pos_y * w + pos_x
    flat_idx = jnp.asarray(flat_idx.reshape(n, h * w))

    def permute_one(img, idx):
        return img.reshape(h * w, -1)[idx].reshape(h, w, -1)

    return jax.vmap(permute_one)(blurred, flat_idx)


# ---------------------------------------------------------------------------
# Streaks: masks are cheap host slicing; the per-pixel blend runs on device.
# ---------------------------------------------------------------------------


def _blend_streak_masks(images, masks, colors, alphas):
    """images (N,H,W,3) u8; masks (N,H,W) u8; colors (N,3); alphas (N,)."""
    m = jnp.asarray(masks)[..., None].astype(jnp.float32)
    color = jnp.asarray(colors, dtype=jnp.float32)[:, None, None, :]
    a = _per_sample(alphas)
    x = images.astype(jnp.float32)
    blended = (1.0 - a) * x + a * color
    out = x * (1.0 - m) + blended * m
    return _finish(out)


def batched_line_streak(images, configs):
    from .distortion.photometric.streak import line_streak_stencils

    n, h, w = images.shape[:3]
    # Two sequential blends, like the host path (line intersections are
    # double-blended there).
    masks_v = np.zeros((n, h, w), dtype=np.uint8)
    masks_h = np.zeros((n, h, w), dtype=np.uint8)
    for i, cfg in enumerate(configs):
        vert, hori = line_streak_stencils(
            (h, w), cfg.thickness, cfg.gap, cfg.dash_thickness, cfg.dash_gap,
            cfg.enable_vert, cfg.enable_hori,
        )
        if vert is not None:
            masks_v[i] = vert
        if hori is not None:
            masks_h[i] = hori
    colors = _field(configs, 'color')
    alphas = _field(configs, 'alpha')
    out = _blend_streak_masks(images, masks_v, colors, alphas)
    return _blend_streak_masks(out, masks_h, colors, alphas)


def batched_rectangle_streak(images, configs):
    from .distortion.photometric.streak import rectangle_streak_stencils

    n, h, w = images.shape[:3]
    masks = np.zeros((n, h, w), dtype=np.uint8)
    for i, cfg in enumerate(configs):
        aspect = cfg.aspect_ratio if cfg.aspect_ratio is not None else w / h
        vert, hori = rectangle_streak_stencils(
            (h, w), cfg.thickness, aspect, cfg.short_side_min,
            cfg.short_side_step, cfg.dash_thickness, cfg.dash_gap,
        )
        masks[i] = vert | hori
    return _blend_streak_masks(
        images, masks, _field(configs, 'color'), _field(configs, 'alpha')
    )


def batched_ellipse_streak(images, configs):
    from .distortion.photometric.streak import (
        concentric_boxes,
        ellipse_ring_stencil,
    )

    n, h, w = images.shape[:3]
    masks = np.zeros((n, h, w), dtype=np.uint8)
    for i, cfg in enumerate(configs):
        aspect = cfg.aspect_ratio if cfg.aspect_ratio is not None else w / h
        boxes = concentric_boxes(h, w, aspect, cfg.short_side_min,
                                 cfg.short_side_step)
        masks[i] = ellipse_ring_stencil(
            (h, w), (w // 2, h // 2),
            [(b.width // 2, b.height // 2) for b in boxes], cfg.thickness,
        )
    return _blend_streak_masks(
        images, masks, _field(configs, 'color'), _field(configs, 'alpha')
    )


def attr_evolve_streak(cfg, **kwargs):
    import attr as _attr
    return _attr.evolve(cfg, **kwargs)


# ---------------------------------------------------------------------------
# Geometric: grid-based warps (camera models / MLS) on device.
# ---------------------------------------------------------------------------


def _native_repair(map_y, map_x, cov) -> bool:
    """In-place C++ repair of uncovered backward-map pixels; False if the
    native library is unavailable (callers run the numpy loop instead)."""
    try:
        from ..native import load_library
        lib = load_library()
    except Exception:  # noqa: BLE001
        return False
    if lib is None or not hasattr(lib, 'vg_repair_backward_maps'):
        return False
    import ctypes
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    cov_u8 = np.ascontiguousarray(cov, dtype=np.uint8)
    assert map_y.flags.c_contiguous and map_x.flags.c_contiguous
    lib.vg_repair_backward_maps(
        map_y.ctypes.data_as(f64p), map_x.ctypes.data_as(f64p),
        cov_u8.ctypes.data_as(u8p), map_y.shape[0], map_y.shape[1],
    )
    return True


def plan_backward_maps(plan, src_shape):
    """(map_y, map_x, coverage) for ANY WarpPlan on its dst canvas.

    Lattice plans repair uncovered dst pixels by row interpolation /
    extension so the shared-slope tap scheme stays monotonic (the active
    mask excludes them anyway); matrix and nop plans cover fully.
    """
    h_in, w_in = src_shape
    from ..ops.warp import affine_maps_np

    if plan.nop:
        ys, xs = np.meshgrid(
            np.arange(h_in, dtype=np.float64),
            np.arange(w_in, dtype=np.float64),
            indexing='ij',
        )
        return ys, xs, np.ones((h_in, w_in), dtype=bool)

    if plan.matrix is not None:
        map_y, map_x = affine_maps_np(plan.matrix, plan.dst_shape)
        return map_y, map_x, np.ones(plan.dst_shape, dtype=bool)

    map_y, map_x, cov = plan.backward_maps()
    map_y = np.asarray(map_y, dtype=np.float64).copy()
    map_x = np.asarray(map_x, dtype=np.float64).copy()
    rows, cols_n = map_x.shape

    native = _native_repair(map_y, map_x, cov)
    if native:
        return map_y, map_x, cov

    cols = np.arange(cols_n, dtype=np.float64)

    # Repair uncovered dst pixels by LINEAR EXTENSION of the covered data.
    # Anything discontinuous here (sentinels, clamps) wrecks the shared-
    # slope two-pass decomposition: tap needs explode and the whole batch
    # falls off the device path.  Extended pixels read outside the source
    # (border value) or bleed a few source pixels; the active mask gates
    # them out downstream either way.
    row_any = cov.any(axis=1)
    covered_rows = np.flatnonzero(row_any)
    row_full = cov.all(axis=1)
    for y in covered_rows:
        if row_full[y]:
            continue  # fully covered row: nothing to repair (common case)
        row_cov = cov[y]
        idx = np.flatnonzero(row_cov)
        first, last = idx[0], idx[-1]
        contiguous = (last - first + 1) == len(idx)
        if not contiguous:
            # Interior holes (rare): interpolate across them.
            fidx = idx.astype(np.float64)
            map_x[y] = np.interp(cols, fidx, map_x[y, idx])
            map_y[y] = np.interp(cols, fidx, map_y[y, idx])
        # Extend with the LOCAL slope at each edge (an 8-px window), not
        # the full-row average: a curved row extended at its tangent stays
        # shape-consistent with its neighbours, keeping the two-pass tap
        # budget small near canvas borders.
        dl = min(last - first, 8)
        if dl > 0:
            sxl = (map_x[y, first + dl] - map_x[y, first]) / dl
            syl = (map_y[y, first + dl] - map_y[y, first]) / dl
            sxr = (map_x[y, last] - map_x[y, last - dl]) / dl
            syr = (map_y[y, last] - map_y[y, last - dl]) / dl
        else:
            sxl = sxr = 1.0
            syl = syr = 0.0
        if first > 0:
            d = cols[:first] - first
            map_x[y, :first] = map_x[y, first] + d * sxl
            map_y[y, :first] = map_y[y, first] + d * syl
        if last < cols_n - 1:
            d = cols[last + 1:] - last
            map_x[y, last + 1:] = map_x[y, last] + d * sxr
            map_y[y, last + 1:] = map_y[y, last] + d * syr
    if len(covered_rows) and len(covered_rows) < rows:
        top, bottom = covered_rows[0], covered_rows[-1]
        dv = min(bottom - top, 8)
        if dv > 0:
            step_y_t = (map_y[top + dv] - map_y[top]) / dv
            step_x_t = (map_x[top + dv] - map_x[top]) / dv
            step_y_b = (map_y[bottom] - map_y[bottom - dv]) / dv
            step_x_b = (map_x[bottom] - map_x[bottom - dv]) / dv
        else:
            step_y_t = step_y_b = np.ones(cols_n)
            step_x_t = step_x_b = np.zeros(cols_n)
        for y in range(0, top):
            map_y[y] = map_y[top] + (y - top) * step_y_t
            map_x[y] = map_x[top] + (y - top) * step_x_t
        for y in range(bottom + 1, rows):
            map_y[y] = map_y[bottom] + (y - bottom) * step_y_b
            map_x[y] = map_x[bottom] + (y - bottom) * step_x_b
        # Interior rows with no coverage (rare): nearest covered row.
        interior = np.flatnonzero(~row_any)
        interior = interior[(interior > top) & (interior < bottom)]
        for y in interior:
            y0 = covered_rows[np.argmin(np.abs(covered_rows - y))]
            near_top = (y0 - top) <= (bottom - y0)
            map_y[y] = map_y[y0] + (y - y0) * (
                step_y_t if near_top else step_y_b
            )
            map_x[y] = map_x[y0] + (y - y0) * (
                step_x_t if near_top else step_x_b
            )
    return map_y, map_x, cov




_INTERP_W_CACHE = {}


def _interp_weights(length: int, nodes: np.ndarray):
    """(length, len(nodes)) float32 bilinear weights through node rows.

    DEVICE-RESIDENT and cached by (length, node grid): the matrices are
    canvas-determined, so rebuilding + re-uploading them every batch
    (~1.3 MB across the four per-batch uses) was pure per-step overhead."""
    key = (length, nodes.tobytes())
    cached = _INTERP_W_CACHE.get(key)
    if cached is not None:
        return cached
    idx = np.searchsorted(nodes, np.arange(length), side='right') - 1
    idx = np.clip(idx, 0, len(nodes) - 2)
    left = nodes[idx]
    right = nodes[idx + 1]
    t = (np.arange(length) - left) / np.maximum(right - left, 1)
    weights = np.zeros((length, len(nodes)), dtype=np.float32)
    rows = np.arange(length)
    weights[rows, idx] = 1.0 - t
    weights[rows, idx + 1] = t
    out = jnp.asarray(weights)
    if len(_INTERP_W_CACHE) > 64:
        _INTERP_W_CACHE.clear()
    _INTERP_W_CACHE[key] = out
    return out


@jax.jit
def _coarse_gather_remap(stack_f32, coarse_y, coarse_x, w_y, w_x, border):
    """Upsample coarse backward maps (tap matmuls) + bilinear gather, one
    program.  Returns (warped, map_y_full, map_x_full) — all on device."""
    from ..ops.warp import remap_f32

    # Absolute source coordinates: TF32 would round them by ~1 px at
    # page widths, so the upsample runs in full f32.
    my = jnp.einsum(
        'hr,nrc,wc->nhw', w_y, coarse_y, w_x,
        preferred_element_type=jnp.float32, precision=lax.Precision.HIGHEST,
    )
    mx = jnp.einsum(
        'hr,nrc,wc->nhw', w_y, coarse_x, w_x,
        preferred_element_type=jnp.float32, precision=lax.Precision.HIGHEST,
    )
    warped = jax.vmap(
        lambda im, a, b: remap_f32(im, a, b, 'bilinear', border),
        in_axes=(0, 0, 0),
    )(stack_f32, my, mx)
    return warped, my, mx


def _matrix_nodes(plan, ys, xs):
    """Evaluate a matrix/nop plan's backward map at node coordinates."""
    if plan.nop or plan.matrix is None:
        gy, gx = np.meshgrid(ys.astype(np.float64),
                             xs.astype(np.float64), indexing='ij')
        return gy, gx
    mat3 = np.eye(3, dtype=np.float64)
    m = np.asarray(plan.matrix, dtype=np.float64)
    mat3[:m.shape[0]] = m
    inv = np.linalg.inv(mat3)
    gx = xs.astype(np.float64)[None, :]
    gy = ys.astype(np.float64)[:, None]
    sx = inv[0, 0] * gx + inv[0, 1] * gy + inv[0, 2]
    sy = inv[1, 0] * gx + inv[1, 1] * gy + inv[1, 2]
    if np.abs(inv[2, :2]).max() > 1e-12:
        w = inv[2, 0] * gx + inv[2, 1] * gy + inv[2, 2]
        w = np.where(np.abs(w) < 1e-12, 1.0, w)
        sx = sx / w
        sy = sy / w
    return sy, sx



def _repair_node_maps(cy, cx, cov, ys, xs):
    """Node-level twin of the full-resolution repair: fill uncovered node
    positions by interpolation / LOCAL-slope extension (float64 in
    place).  Extended values are shape-consistent with their rows, which
    keeps the banded tap budget small near canvas borders.  Vectorized
    across rows (the per-row python loop was the node-building hot spot);
    only rows with interior coverage gaps (rare: boundary rounding) take
    a per-row np.interp pass."""
    rows, cols = cov.shape
    xs_f = xs.astype(np.float64)
    ys_f = ys.astype(np.float64)
    row_any = cov.any(axis=1)
    covered_rows = np.flatnonzero(row_any)
    if len(covered_rows) == 0:
        return
    cr = covered_rows
    first = cov[cr].argmax(axis=1)
    last = cols - 1 - cov[cr][:, ::-1].argmax(axis=1)
    counts = cov[cr].sum(axis=1)
    for i in np.flatnonzero(counts != (last - first + 1)):
        r = cr[i]
        idx = np.flatnonzero(cov[r])
        fx = xs_f[idx]
        cx[r] = np.interp(xs_f, fx, cx[r, idx])
        cy[r] = np.interp(xs_f, fx, cy[r, idx])

    partial = np.flatnonzero((first > 0) | (last < cols - 1))
    if len(partial):
        pr = cr[partial]
        pf = first[partial]
        pl = last[partial]
        ar = np.arange(len(pr))
        cxr = cx[pr]
        cyr = cy[pr]
        f1 = np.minimum(pf + 1, pl)
        l1 = np.maximum(pl - 1, pf)
        gl = np.maximum(xs_f[f1] - xs_f[pf], 1.0)
        gr = np.maximum(xs_f[pl] - xs_f[l1], 1.0)
        sxl = (cxr[ar, f1] - cxr[ar, pf]) / gl
        syl = (cyr[ar, f1] - cyr[ar, pf]) / gl
        sxr = (cxr[ar, pl] - cxr[ar, l1]) / gr
        syr = (cyr[ar, pl] - cyr[ar, l1]) / gr
        deg = pl == pf
        sxl = np.where(deg, 1.0, sxl)
        syl = np.where(deg, 0.0, syl)
        sxr = np.where(deg, 1.0, sxr)
        syr = np.where(deg, 0.0, syr)
        colg = np.arange(cols)[None, :]
        left_m = colg < pf[:, None]
        right_m = colg > pl[:, None]
        dl = xs_f[None, :] - xs_f[pf][:, None]
        dr = xs_f[None, :] - xs_f[pl][:, None]
        cxr = np.where(left_m, cxr[ar, pf][:, None] + dl * sxl[:, None], cxr)
        cxr = np.where(right_m, cxr[np.arange(len(pr)), pl][:, None]
                       + dr * sxr[:, None], cxr)
        cyr = np.where(left_m, cy[pr][ar, pf][:, None] + dl * syl[:, None],
                       cyr)
        cyr = np.where(right_m, cy[pr][ar, pl][:, None] + dr * syr[:, None],
                       cyr)
        cx[pr] = cxr
        cy[pr] = cyr

    if len(covered_rows) == rows:
        return
    top, bottom = covered_rows[0], covered_rows[-1]
    t1 = min(top + 1, bottom)
    b1 = max(bottom - 1, top)
    gt = max(ys_f[t1] - ys_f[top], 1.0)
    gb = max(ys_f[bottom] - ys_f[b1], 1.0)
    sy_t = (cy[t1] - cy[top]) / gt
    sx_t = (cx[t1] - cx[top]) / gt
    sy_b = (cy[bottom] - cy[b1]) / gb
    sx_b = (cx[bottom] - cx[b1]) / gb
    if bottom == top:
        sy_t = sy_b = np.ones(cols)
        sx_t = sx_b = np.zeros(cols)
    if top > 0:
        d = (ys_f[:top] - ys_f[top])[:, None]
        cy[:top] = cy[top][None] + d * sy_t[None]
        cx[:top] = cx[top][None] + d * sx_t[None]
    if bottom < rows - 1:
        d = (ys_f[bottom + 1:] - ys_f[bottom])[:, None]
        cy[bottom + 1:] = cy[bottom][None] + d * sy_b[None]
        cx[bottom + 1:] = cx[bottom][None] + d * sx_b[None]
    interior = np.flatnonzero(~row_any)
    interior = interior[(interior > top) & (interior < bottom)]
    for r in interior:
        r0 = covered_rows[np.argmin(np.abs(covered_rows - r))]
        near_top = (r0 - top) <= (bottom - r0)
        d = ys_f[r] - ys_f[r0]
        cy[r] = cy[r0] + d * (sy_t if near_top else sy_b)
        cx[r] = cx[r0] + d * (sx_t if near_top else sx_b)


def lattice_node_maps(plan, ys, xs):
    """(cy, cx) float64 node-sampled backward maps for a lattice plan,
    repaired at node level; None when the native kernel is unavailable
    (callers fall back to full-resolution maps + subsampling)."""
    try:
        from ..native import load_library
        lib = load_library()
    except Exception:  # noqa: BLE001
        return None
    if lib is None or not hasattr(lib, 'vg_lattice_node_maps'):
        return None
    import ctypes
    f64p = ctypes.POINTER(ctypes.c_double)
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    u8p = ctypes.POINTER(ctypes.c_uint8)

    inv_mats = np.ascontiguousarray(
        plan._cell_mats(inverse=True), dtype=np.float64
    )
    quads = np.ascontiguousarray(plan._quads('dst'), dtype=np.float64)
    dst_h, dst_w = plan.dst_shape
    ys32 = np.ascontiguousarray(ys, dtype=np.int32)
    xs32 = np.ascontiguousarray(xs, dtype=np.int32)
    cy = np.zeros((len(ys), len(xs)), dtype=np.float32)
    cx = np.zeros((len(ys), len(xs)), dtype=np.float32)
    cov = np.zeros((len(ys), len(xs)), dtype=np.uint8)
    lib.vg_lattice_node_maps(
        quads.ctypes.data_as(f64p), inv_mats.ctypes.data_as(f64p),
        len(quads), dst_h, dst_w,
        ys32.ctypes.data_as(i32p), len(ys32),
        xs32.ctypes.data_as(i32p), len(xs32),
        cy.ctypes.data_as(f32p), cx.ctypes.data_as(f32p),
        cov.ctypes.data_as(u8p),
    )
    cy = cy.astype(np.float64)
    cx = cx.astype(np.float64)
    _repair_node_maps(cy, cx, cov.astype(bool), ys, xs)
    return cy, cx


# Coarse-node spacing of the banded/gather warp paths.  The node arrays
# are per-draw jit ARGUMENTS, so on a slow host<->device link their
# transfer dominates the randomized warp step (~2 MB/step at 8 px on a
# 704^2 canvas).  16 px keeps the documented fidelity bars on
# production-size canvases (max <= 24 LSB at isolated high-gradient
# pixels, mean <= 1 LSB — the catalog's fields are piecewise-projective
# per lattice cell with grid_size >= 16, re-verified by
# tests/ops/test_dense_warp at this spacing) at a 4x transfer/planning
# cut.  Small canvases keep the 8-px grid: their fields bend faster
# relative to the node spacing (same lattice curvature over far fewer
# nodes), and their node arrays are tiny anyway.
COARSE_NODE_STEP = 16
_FINE_NODE_CANVAS = 320      # min(canvas) below this -> 8-px nodes


def _build_coarse_nodes(map_list, shapes, canvas, node_step: Optional[int] = None):
    """Sample every sample's backward field at shared coarse nodes.

    ``map_list`` entries are either (map_y, map_x) full-res arrays
    (lattice plans) or WarpPlan objects (matrix/nop — evaluated
    analytically at the nodes, valid beyond the dst canvas too).
    Returns (coarse_y, coarse_x, ys, xs) with linear extension beyond
    each sample's own canvas."""
    if node_step is None:
        node_step = (
            8 if min(canvas) < _FINE_NODE_CANVAS else COARSE_NODE_STEP
        )
    h_max, w_max = canvas
    n = len(map_list)
    ys = np.round(
        np.linspace(0, h_max - 1, max(2, (h_max - 1) // node_step + 1))
    ).astype(np.int64)
    xs = np.round(
        np.linspace(0, w_max - 1, max(2, (w_max - 1) // node_step + 1))
    ).astype(np.int64)
    # Symmetric grids let per-sample axis flips reuse reversed node values
    # (ops/warp_banded.py).
    ys = np.unique(np.concatenate([ys, h_max - 1 - ys]))
    xs = np.unique(np.concatenate([xs, w_max - 1 - xs]))

    coarse_y = np.empty((n, len(ys), len(xs)), dtype=np.float32)
    coarse_x = np.empty((n, len(ys), len(xs)), dtype=np.float32)
    for idx, entry in enumerate(map_list):
        if not isinstance(entry, tuple):
            if getattr(entry, 'is_lattice', False):
                res = lattice_node_maps(entry, ys, xs)
                if res is not None:
                    coarse_y[idx], coarse_x[idx] = res
                    continue
                entry = plan_backward_maps(entry, entry.src_shape)[:2]
            else:
                cy, cx = _matrix_nodes(entry, ys, xs)
                coarse_y[idx] = cy
                coarse_x[idx] = cx
                continue
        my, mx = entry
        h, w = shapes[idx]
        if h == h_max and w == w_max:
            coarse_y[idx] = my[np.ix_(ys, xs)]
            coarse_x[idx] = mx[np.ix_(ys, xs)]
            continue
        # Linear extension beyond this sample's dst canvas (same rule as
        # the dense padding path): extend columns then rows.
        ys_in = np.minimum(ys, h - 1)
        xs_in = np.minimum(xs, w - 1)
        cy = my[np.ix_(ys_in, xs_in)].astype(np.float64)
        cx = mx[np.ix_(ys_in, xs_in)].astype(np.float64)
        over_x = xs > w - 1
        if over_x.any() and w > 1:
            # Local edge slope (8-px window) — see plan_backward_maps.
            dl = min(w - 1, 8)
            step_x = (mx[ys_in, w - 1] - mx[ys_in, w - 1 - dl]) / dl
            step_y = (my[ys_in, w - 1] - my[ys_in, w - 1 - dl]) / dl
            d = (xs[over_x] - (w - 1)).astype(np.float64)
            cx[:, over_x] = mx[ys_in, w - 1][:, None] + d[None, :] * step_x[:, None]
            cy[:, over_x] = my[ys_in, w - 1][:, None] + d[None, :] * step_y[:, None]
        over_y = ys > h - 1
        if over_y.any() and h > 1:
            inside = np.flatnonzero(~over_y)
            last = inside[-1]
            prev = inside[-2] if len(inside) > 1 else inside[-1]
            gap = max(int(ys[last] - ys[prev]), 1)
            step_cy = (cy[last] - cy[prev]) / gap
            step_cx = (cx[last] - cx[prev]) / gap
            d = (ys[over_y] - ys[last]).astype(np.float64)
            cy[over_y] = cy[last][None, :] + d[:, None] * step_cy[None, :]
            cx[over_y] = cx[last][None, :] + d[:, None] * step_cx[None, :]
        coarse_y[idx] = cy
        coarse_x[idx] = cx

    return coarse_y, coarse_x, ys, xs


# Rows each warp route ran in the last batched_plan_warp call
# (sub-batches count their bucket padding); a diagnostic for callers.
LAST_ROUTES = {}


def _note_route(route: str, rows: int) -> None:
    LAST_ROUTES[route] = LAST_ROUTES.get(route, 0) + int(rows)


def _coarse_gather_warp(images, map_list, shapes, canvas, border_value,
                        node_step: Optional[int] = None, nodes=None):
    """Gather-warp a batch from node-sampled backward maps (the fallback
    device program when the segmented two-pass rejects the field)."""
    h_max, w_max = canvas
    if nodes is None:
        nodes = _build_coarse_nodes(map_list, shapes, canvas, node_step)
    coarse_y, coarse_x, ys, xs = nodes
    _note_route('gather', len(coarse_y))

    w_y = _interp_weights(h_max, ys)
    w_x = _interp_weights(w_max, xs)

    images = jnp.asarray(images)
    orig_dtype = images.dtype
    warped, my_full, mx_full = _coarse_gather_remap(
        images.astype(jnp.float32),
        jnp.asarray(coarse_y), jnp.asarray(coarse_x),
        jnp.asarray(w_y), jnp.asarray(w_x),
        float(border_value),
    )
    if jnp.issubdtype(orig_dtype, jnp.integer):
        warped = jnp.clip(jnp.round(warped), 0, 255).astype(orig_dtype)
    return warped, (my_full, mx_full)


@jax.jit
def _upsample_node_maps(coarse_y, coarse_x, w_y, w_x):
    """Full-res (map_ys, map_xs) on device from node maps (tap matmuls)."""
    # Absolute source coordinates: TF32 would round them by ~1 px at
    # page widths, so the upsample runs in full f32.
    my = jnp.einsum(
        'hr,nrc,wc->nhw', w_y, coarse_y, w_x,
        preferred_element_type=jnp.float32, precision=lax.Precision.HIGHEST,
    )
    mx = jnp.einsum(
        'hr,nrc,wc->nhw', w_y, coarse_x, w_x,
        preferred_element_type=jnp.float32, precision=lax.Precision.HIGHEST,
    )
    return my, mx


@jax.jit
def _scatter_samples(out, idx, values):
    return out.at[idx].set(values)


import functools as _functools


@_functools.partial(
    jax.jit,
    static_argnames=('canvas', 'taps', 'border_value', 'init'),
    donate_argnums=(0,),
)
def _banded_group_scatter(out, x, idx, plan, flip_v, flip_h,
                          canvas, taps, border_value, init):
    """ONE dispatch per tap-homogeneous group: gather the sub-batch,
    run both banded passes + unflip, scatter into the batch canvas.
    ``init`` builds the canvas inside the program (saves the eager
    jnp.zeros dispatch for the first group)."""
    from ..ops.warp_banded import banded_warp_body

    sub = jnp.take(x, idx, axis=0)
    res = banded_warp_body(sub, plan, canvas, taps,
                           flips=(flip_v, flip_h),
                           border_value=border_value)
    if init:
        h, w = canvas
        out = jnp.zeros((x.shape[0], h, w) + x.shape[3:], res.dtype)
    return out.at[idx].set(res)


@_functools.partial(jax.jit, static_argnames=('n',))
def _merge_subbatches(idx_a, wa, idx_b, wb, n):
    """Scatter two warped sub-batches onto one zeroed batch canvas in a
    single program (was: zeros + two eager scatters = three dispatches)."""
    out = jnp.zeros((n,) + tuple(wa.shape[1:]), dtype=wa.dtype)
    return out.at[idx_a].set(wa).at[idx_b].set(wb.astype(wa.dtype))


@_functools.partial(
    jax.jit,
    static_argnames=('statics', 'border_value', 'gather', 'use_quads'),
)
def _affine_sub_warp(x, idx, quads, aplan, statics, border_value,
                     gather, use_quads):
    """ONE dispatch for the affine sub-batch: optional gather + the exact
    two-shear warp (with per-sample rot90 conditioning when any quadrant
    reduction fired)."""
    from ..ops.warp_mxu import apply_affine_warp, apply_affine_warp_quad

    sub = jnp.take(x, idx, axis=0) if gather else x
    if use_quads:
        return apply_affine_warp_quad(
            sub, quads, aplan, statics, border_value=border_value
        )
    return apply_affine_warp(
        sub, aplan, statics, border_value=border_value
    )


@jax.jit
def _mean_pool2(x):
    """(N, H, W, ...) -> (N, H/2, W/2, ...) 2x2 mean pool."""
    return (
        x[:, 0::2, 0::2] + x[:, 1::2, 0::2]
        + x[:, 0::2, 1::2] + x[:, 1::2, 1::2]
    ) * 0.25


class LazyCoverages:
    """Per-sample coverage planes, materialized on ACCESS: the lattice
    coverage is a host polygon rasterization per plan per batch, and no
    hot caller consumes it (bench/synth gate by their own active masks).
    Matrix/nop coverage is a zero-copy broadcast view."""

    def __init__(self, plans):
        self._plans = list(plans)
        self._cache = {}

    def __len__(self):
        return len(self._plans)

    def __getitem__(self, i):
        if i not in self._cache:
            plan = self._plans[i]
            if getattr(plan, 'is_lattice', False):
                from .distortion.warp_plan import warp_active_mask
                self._cache[i] = warp_active_mask(plan).mat.astype(bool)
            else:
                self._cache[i] = np.broadcast_to(True, plan.dst_shape)
        return self._cache[i]

    def __iter__(self):
        return (self[i] for i in range(len(self)))


def _bucket_pad(idx: np.ndarray, n: int,
                ladder=(8, 16, 32, 64)) -> np.ndarray:
    """Pad an index subset to a fixed bucket-size ladder (each sub-batch
    size is a distinct compiled program; padding repeats the first index,
    whose duplicate scatter writes are identical values)."""
    for b in ladder:
        if len(idx) <= b <= n:
            return np.concatenate([
                idx, np.full(b - len(idx), idx[0], dtype=idx.dtype)
            ])
    return idx


def _coarse_mxu_warp(images, nodes, src_shape, canvas, border_value,
                     return_maps: bool, content_boxes=None):
    """Banded two-pass warp from node maps (ops/warp_banded.py); samples
    the decomposition rejects (fold-overs, extreme zooms) run the gather
    program as a sub-batch and overwrite their rows.  Returns None only
    when EVERY sample rejects (the caller then gathers the whole batch —
    one program beats scatter assembly).

    The banded cost scales with taps x samples, and per-sample tap needs
    spread widely (perspective ~33, lattice median ~75, tail > 128), so
    accepted samples split into tap-homogeneous GROUPS (<= 48 / <= 128),
    each running at its own quantized tap count on a bucket-padded
    sub-batch — a mixed batch no longer pays the max everywhere."""
    from ..ops.warp_banded import (
        _quantize_taps,
        apply_banded_warp,
        plan_banded_warp,
        slice_banded_plan,
    )

    coarse_y, coarse_x, ys, xs = nodes
    n = len(coarse_y)
    planned = plan_banded_warp(
        coarse_y, coarse_x, ys, xs, src_shape, canvas,
        content_boxes=content_boxes,
    )
    if planned is None:
        return None
    plan, taps, rejects, flips, needs = planned

    images = jnp.asarray(images)
    orig_dtype = images.dtype
    x = images.astype(jnp.float32)

    reject_set = set(int(r) for r in rejects)
    acc = np.asarray(
        [i for i in range(n) if i not in reject_set], dtype=np.int64
    )
    # ONE tap group.  A low/high split saved ~(taps_hi - 48) tap rounds
    # for the light half, but every (bucket, taps) pair is a distinct
    # fused program and randomized-policy draws walked the whole product
    # set, and a recompile costs far more than the extra taps.
    groups = [(acc, _quantize_taps(int(needs[acc].max())))] \
        if len(acc) else []
    _note_route('banded', len(acc))

    if len(groups) == 1 and len(groups[0][0]) == n:
        warped = apply_banded_warp(
            x, plan, canvas, groups[0][1], flips=flips,
            border_value=border_value,
        )
    else:
        # First group's program zero-inits its own canvas; the dummy
        # placeholder must NOT alias x (arg 0 is donated).
        warped = jnp.zeros((0,), dtype=jnp.float32)
        for pos, (gidx, gtaps) in enumerate(groups):
            gpad = _bucket_pad(gidx, n)
            warped = _banded_group_scatter(
                warped, x, jnp.asarray(gpad),
                slice_banded_plan(plan, gpad),
                jnp.asarray(flips[0][gpad]), jnp.asarray(flips[1][gpad]),
                tuple(canvas), gtaps, border_value, pos == 0,
            )
    if len(rejects):
        ridx = _bucket_pad(rejects, n, ladder=(8, 16))
        done = False
        h2, w2 = src_shape[0] // 2, src_shape[1] // 2
        if src_shape[0] % 2 == 0 and src_shape[1] % 2 == 0:
            # 2x-downscale tail: rejects are extreme ZOOMS (needs beyond
            # the tap ladder, i.e. local source spans > 128 px per output
            # block).  A mean-pool prefilter halves every slope — the
            # correct anti-aliasing for that regime — and the halved
            # field re-plans under the ladder.  Half-pixel centers:
            # source coord s lands at 0.5*s - 0.25 in the pooled image.
            planned2 = plan_banded_warp(
                coarse_y[ridx] * 0.5 - 0.25, coarse_x[ridx] * 0.5 - 0.25,
                ys, xs, (h2, w2), canvas,
                content_boxes=(None if content_boxes is None
                               else content_boxes[ridx]),
            )
            if planned2 is not None and len(planned2[2]) == 0:
                plan2, taps2, _, flips2, _ = planned2
                idx_dev = jnp.asarray(ridx)
                sub_half = _mean_pool2(jnp.take(x, idx_dev, axis=0))
                res = apply_banded_warp(
                    sub_half, plan2, canvas, taps2, flips=flips2,
                    border_value=border_value,
                )
                warped = _scatter_samples(warped, idx_dev, res)
                _note_route('banded_half_res', len(ridx))
                done = True
        if not done:
            # Gather fallback (fold-overs the half-res plan still
            # rejects).
            idx_dev = jnp.asarray(ridx)
            sub = jnp.take(x, idx_dev, axis=0)
            sub_nodes = (coarse_y[ridx], coarse_x[ridx], ys, xs)
            res, _ = _coarse_gather_warp(
                sub, [None] * len(ridx), None, canvas, border_value,
                nodes=sub_nodes,
            )
            warped = _scatter_samples(warped, idx_dev, res)

    if jnp.issubdtype(orig_dtype, jnp.integer):
        warped = jnp.clip(jnp.round(warped), 0, 255).astype(orig_dtype)
    else:
        warped = warped.astype(orig_dtype)

    dev_maps = None
    if return_maps:
        h_max, w_max = canvas
        dev_maps = _upsample_node_maps(
            jnp.asarray(coarse_y.astype(np.float32)),
            jnp.asarray(coarse_x.astype(np.float32)),
            jnp.asarray(_interp_weights(h_max, ys)),
            jnp.asarray(_interp_weights(w_max, xs)),
        )
    return warped, dev_maps


def batched_plan_warp(
    plans: Sequence,
    images,
    border_value: float = 0.0,
    taps_max: int = 24,
    return_maps: bool = False,
    canvas_shape: Optional[Tuple[int, int]] = None,
    mode: str = 'auto',
):
    """Warp each batch sample by its own WarpPlan in ONE device program.

    Routing under ``mode='auto'`` (fastest first):
      1. all-affine batches -> the exact two-shear warp (3 taps);
      2. everything else -> the coarse-node SEGMENTED two-pass (shifts +
         tap matmuls planned at ~1/64th of the pixels,
         ops/warp_mxu.py plan_coarse_twopass_warp);
      3. fields the two-pass rejects (fold-overs, tap budget) -> the
         fused bilinear-gather program.
    ``mode='gather'`` forces 3; ``mode='dense'`` forces the legacy
    full-resolution dense two-pass planning (host-heavy; kept for
    comparison and for callers that need its exact tap scheme).

    Canvases pad to the batch max; returns (warped (N, Hmax, Wmax, C)
    with the input dtype, result_shapes, coverages); with
    ``return_maps`` also device (map_ys, map_xs) — the synth pipeline
    differentiates them for local-stretch label corrections (None when
    the affine path ran; its maps are analytic).

    ``canvas_shape``: optional STATIC padded canvas.  Per-sample dst
    canvases pad to it instead of the batch max, so every batch compiles
    the same device program (dst shapes vary per random draw otherwise).
    Grown automatically if a sample's dst exceeds it.

    Contract: warped pixels OUTSIDE a sample's coverage are undefined —
    the two-pass paths extend the backward field linearly past each
    sample's canvas (keeping tap budgets small), so uncovered regions may
    carry bled source content rather than ``border_value``.  Callers must
    gate by the returned coverages / the plan's active mask (the synth
    pipeline and batch_random_geometric_distort do).
    """
    from ..ops.warp_mxu import plan_dense_warp, apply_dense_warp
    import jax as _jax

    n, h_in, w_in = images.shape[:3]
    assert len(plans) == n
    LAST_ROUTES.clear()

    shapes = [plan.dst_shape for plan in plans]
    h_max = max(s[0] for s in shapes)
    w_max = max(s[1] for s in shapes)
    if canvas_shape is not None:
        h_max = max(h_max, canvas_shape[0])
        w_max = max(w_max, canvas_shape[1])

    # Per-sample partition: affine plans (nop included) run the EXACT
    # two-shear program (3 taps; quadrant rot90 reduction conditions
    # any rotation angle), non-affine plans (lattice fields, perspective
    # skews) run the banded two-pass program.  Mixed batches run both
    # sub-programs on index-bucketed sub-batches and scatter-merge —
    # without the split, one rotated sample drags the whole batch onto
    # the 128-tap banded ladder.  Probed from plan matrices alone: no
    # dense map materializes for affine samples.
    aff_sel = np.zeros(n, dtype=bool)
    aff_mats = np.tile(np.eye(3, dtype=np.float64), (n, 1, 1))
    aff_quads = np.zeros(n, dtype=np.int8)
    if mode == 'auto':
        from ..ops.warp_mxu import quadrant_reduce_mats

        for i, plan in enumerate(plans):
            if plan.is_lattice:
                continue
            mat3 = np.eye(3, dtype=np.float64)
            if plan.matrix is not None:
                m = np.asarray(plan.matrix, dtype=np.float64)
                mat3[:m.shape[0]] = m
            if np.abs(mat3[2, :2]).max() > 1e-9:
                continue  # perspective (skew_hori/vert) -> banded
            aff_sel[i] = True
            aff_mats[i] = mat3
        if aff_sel.any():
            quads, reduced = quadrant_reduce_mats(
                aff_mats[aff_sel], (h_in, w_in)
            )
            # Residual conditioning check: extreme anisotropic zoom-in
            # can defeat the decomposition even post-reduction (rare).
            cond = np.abs(np.linalg.inv(reduced)[:, 0, 0]) > 0.18
            sel_idx = np.flatnonzero(aff_sel)
            aff_sel[sel_idx[~cond]] = False
            keep = np.flatnonzero(cond)
            aff_quads[sel_idx[keep]] = quads[keep]
            aff_mats[sel_idx[keep]] = reduced[keep]

    if mode == 'auto' and aff_sel.any():
        from ..ops.warp_mxu import (
            apply_affine_warp,
            apply_affine_warp_quad,
            plan_affine_warp,
        )

        aff_idx = np.flatnonzero(aff_sel)
        # The 3-tap program is cheap: pad to the FULL batch always (one
        # compiled size) unless a small bucket fits.
        aff_idx_p = _bucket_pad(aff_idx, n, ladder=(8, n))
        try:
            aplan, astatics = plan_affine_warp(
                aff_mats[aff_idx_p], (h_in, w_in), (h_max, w_max),
                canonical=True,
            )
        except AssertionError:
            # Span exceeds every shift kernel (huge canvases) — fall
            # through to the banded/gather routing for the whole batch.
            aplan = None
            aff_sel[:] = False
    if mode == 'auto' and aff_sel.any() and aplan is not None:
        coverages = LazyCoverages(plans)
        quads_p = aff_quads[aff_idx_p]
        direct = (
            len(aff_idx_p) == n and aff_sel.all()
            and np.array_equal(aff_idx_p, np.arange(n))
        )
        wa = _affine_sub_warp(
            jnp.asarray(images),
            (jnp.zeros((0,), jnp.int32) if direct
             else jnp.asarray(aff_idx_p)),
            jnp.asarray(quads_p), aplan, astatics, border_value,
            not direct, not (quads_p == 0).all(),
        )
        _note_route('affine', len(aff_idx_p))

        if aff_sel.all():
            if return_maps:
                # Affine maps are analytic; callers needing the local
                # stretch derive it from the matrices (see synth.device).
                return wa, shapes, coverages, None
            return wa, shapes, coverages

        # Mixed batch: banded sub-program on the rest, scatter-merge.
        rest_idx = np.flatnonzero(~aff_sel)
        rest_idx_p = _bucket_pad(rest_idx, n)
        # Node maps build once per UNIQUE plan; bucket-padding duplicates
        # only index into the built arrays.
        pad_map = np.concatenate([
            np.arange(len(rest_idx)),
            np.zeros(len(rest_idx_p) - len(rest_idx), dtype=np.int64),
        ])
        nodes_all = None
        if return_maps:
            nodes_all = _build_coarse_nodes(
                list(plans), shapes, (h_max, w_max)
            )
            cy, cx, nys, nxs = nodes_all
            rest_nodes = (cy[rest_idx_p], cx[rest_idx_p], nys, nxs)
        else:
            rest_plans_u = [plans[i] for i in rest_idx]
            cy, cx, nys, nxs = _build_coarse_nodes(
                rest_plans_u, [p.dst_shape for p in rest_plans_u],
                (h_max, w_max),
            )
            rest_nodes = (cy[pad_map], cx[pad_map], nys, nxs)
        from .distortion.warp_plan import plan_content_box
        boxes_u = np.asarray([
            (b.up, b.down, b.left, b.right)
            for b in (plan_content_box(plans[i]) for i in rest_idx)
        ], dtype=np.int64)
        boxes = boxes_u[pad_map]
        sub_r = jnp.take(jnp.asarray(images), jnp.asarray(rest_idx_p),
                         axis=0)
        result = _coarse_mxu_warp(
            sub_r, rest_nodes, (h_in, w_in), (h_max, w_max),
            border_value, return_maps=False, content_boxes=boxes,
        )
        if result is not None:
            wr = result[0]
        else:
            wr, _ = _coarse_gather_warp(
                sub_r, [None] * len(rest_idx_p), None, (h_max, w_max),
                border_value, nodes=rest_nodes,
            )
        out = _merge_subbatches(
            jnp.asarray(aff_idx_p), wa, jnp.asarray(rest_idx_p), wr, n
        )
        if return_maps:
            cy, cx, nys, nxs = nodes_all
            dev_maps = _upsample_node_maps(
                jnp.asarray(cy.astype(np.float32)),
                jnp.asarray(cx.astype(np.float32)),
                jnp.asarray(_interp_weights(h_max, nys)),
                jnp.asarray(_interp_weights(w_max, nxs)),
            )
            return out, shapes, coverages, dev_maps
        return out, shapes, coverages

    map_list = []
    coverages = []
    if mode != 'dense':
        # Lazy: matrix/nop maps are analytic, and lattice maps are
        # evaluated at the coarse NODES only (native kernel) — no
        # full-res float planes per sample.  Lattice coverage is the
        # active border-polygon fill (same region as the per-cell
        # rasterization up to boundary rounding), materialized only if a
        # caller reads it.
        map_list = list(plans)
        coverages = LazyCoverages(plans)
    else:
        for plan in plans:
            map_y, map_x, cov = plan_backward_maps(plan, (h_in, w_in))
            map_list.append((map_y, map_x))
            coverages.append(cov)

    if mode != 'dense':
        # Coarse-node paths: only ~1/64th of the backward field crosses
        # the host->device link (full maps would be ~125MB/batch).  The
        # banded two-pass serves smooth fields; batches it rejects
        # (fold-over rows, tap budget) run the fused bilinear-gather
        # program instead.
        nodes = _build_coarse_nodes(map_list, shapes, (h_max, w_max))
        if mode != 'gather':
            from .distortion.warp_plan import plan_content_box
            boxes = np.asarray([
                (b.up, b.down, b.left, b.right)
                for b in (plan_content_box(p) for p in plans)
            ], dtype=np.int64)
            result = _coarse_mxu_warp(
                images, nodes, (h_in, w_in), (h_max, w_max), border_value,
                return_maps, content_boxes=boxes,
            )
            if result is not None:
                warped, dev_maps = result
                if return_maps:
                    return warped, shapes, coverages, dev_maps
                return warped, shapes, coverages
        warped, dev_maps = _coarse_gather_warp(
            images, map_list, shapes, (h_max, w_max), border_value,
            nodes=nodes,
        )
        if return_maps:
            return warped, shapes, coverages, dev_maps
        return warped, shapes, coverages

    map_ys = np.zeros((n, h_max, w_max), dtype=np.float32)
    map_xs = np.zeros((n, h_max, w_max), dtype=np.float32)
    for idx, (my, mx) in enumerate(map_list):
        h, w = my.shape
        map_ys[idx, :h, :w] = my
        map_xs[idx, :h, :w] = mx
        # Pad beyond each sample's canvas by linear extension (smooth maps
        # keep the two-pass tap budget small; extended pixels resolve to
        # the border or are gated by the active mask downstream).
        if w < w_max:
            pad = np.arange(1, w_max - w + 1, dtype=np.float64)
            step_x = (mx[:, -1:] - mx[:, :1]) / max(w - 1, 1)
            step_y = (my[:, -1:] - my[:, :1]) / max(w - 1, 1)
            map_xs[idx, :h, w:] = mx[:, -1:] + pad[None, :] * step_x
            map_ys[idx, :h, w:] = my[:, -1:] + pad[None, :] * step_y
        if h < h_max:
            pad = np.arange(1, h_max - h + 1, dtype=np.float64)
            step_x = (map_xs[idx, h - 1] - map_xs[idx, 0]) / max(h - 1, 1)
            step_y = (map_ys[idx, h - 1] - map_ys[idx, 0]) / max(h - 1, 1)
            map_xs[idx, h:] = map_xs[idx, h - 1][None] \
                + pad[:, None] * step_x[None]
            map_ys[idx, h:] = map_ys[idx, h - 1][None] \
                + pad[:, None] * step_y[None]

    # Routing: the two-pass scheme covers fields whose non-separable
    # residual fits the tap budget (affine chains, mild grid warps); a
    # batch containing stronger draws (typical camera perspective / MLS at
    # mid levels has per-line slope variation worth 50-120 taps) runs as
    # ONE fused bilinear-gather program instead, a single compilation.
    from ..ops.warp_mxu import (
        dense_warp_positions,
        line_tap_needs,
        line_window_needs,
        plan_dense_warp_from_positions,
    )

    pos_v, map_xs_fixed, row_monotone = dense_warp_positions(
        map_ys, map_xs, (h_in, w_in)
    )
    needs = np.maximum(
        line_tap_needs(pos_v), line_tap_needs(map_xs_fixed)
    )

    def window_fits(spans, in_len):
        slab = in_len + spans + taps_max <= 1792
        return (spans + taps_max <= 832) | slab

    windows_ok = (
        window_fits(line_window_needs(pos_v), h_in)
        & window_fits(line_window_needs(map_xs_fixed), w_in)
    )
    two_pass = bool(
        (row_monotone & (needs <= taps_max) & windows_ok).all()
    )

    if two_pass:
        try:
            plan_, statics = plan_dense_warp_from_positions(
                pos_v, map_xs_fixed, (h_in, w_in), taps_max=taps_max
            )
        except AssertionError:
            plan_ = None  # window estimate undershot (rare)
        if plan_ is not None:
            fn = _jax.jit(
                apply_dense_warp, static_argnames=('statics', 'border_value')
            )
            warped = fn(
                images, plan_, statics=statics, border_value=border_value
            )
            if return_maps:
                return warped, shapes, coverages, (map_ys, map_xs)
            return warped, shapes, coverages

    warped, dev_maps = _coarse_gather_warp(
        images, map_list, shapes, (h_max, w_max), border_value
    )
    if return_maps:
        return warped, shapes, coverages, dev_maps
    return warped, shapes, coverages


def batched_grid_warp(
    distortion,
    configs: Sequence,
    images,
    rng=None,
    border_value: float = 0.0,
    taps_max: int = 24,
):
    """Batch one geometric distortion (per-sample configs) through the
    batched warp; see batched_plan_warp."""
    n, h_in, w_in = images.shape[:3]
    assert len(configs) == n
    if rng is None:
        rng = np.random.default_rng(0)
    plans = [distortion.plan(cfg, (h_in, w_in), rng) for cfg in configs]
    return batched_plan_warp(plans, images, border_value, taps_max)


# ---------------------------------------------------------------------------
# Config-driven dispatch: the same DistortionConfig classes as the
# per-element API, stacked across the batch.
# ---------------------------------------------------------------------------


def _field(configs, name):
    return [getattr(cfg, name) for cfg in configs]


def _uniform(configs, name):
    values = _field(configs, name)
    assert all(v == values[0] for v in values), (
        f'{name} must be shared across the batch for the device path'
    )
    return values[0]


def batch_distort_images(name: str, configs: Sequence, images, key=None):
    """Apply one catalog distortion to a uint8 (N, H, W, 3) batch.

    ``configs``: one DistortionConfig per sample (len N).  Static/shape
    parameters must agree across the batch; per-sample numeric parameters
    may differ freely.
    """
    n = images.shape[0]
    assert len(configs) == n
    if key is None:
        key = jax.random.PRNGKey(0)

    if name == 'mean_shift':
        deltas = _field(configs, 'delta')
        thresholds = _field(configs, 'threshold')
        if all(t is None for t in thresholds):
            thresholds = None
        else:
            # None -> a sentinel making the gate always true for that
            # sample's delta sign (delta>0 gates on x<=t, else t<=x).
            thresholds = [
                t if t is not None else (255 if d > 0 else 0)
                for t, d in zip(thresholds, deltas)
            ]
        return batched_mean_shift(
            images, deltas, thresholds,
            channels=_uniform(configs, 'channels'),
            oob_behavior=_uniform(configs, 'oob_behavior'),
        )
    if name == 'color_shift':
        return batched_color_shift(images, _field(configs, 'delta'))
    if name == 'brightness_shift':
        from ..element import ImageMode  # local to avoid cycles at import

        mode = _uniform(configs, 'intermediate_image_mode')
        return batched_brightness_shift(
            images, _field(configs, 'delta'), use_hsv=(mode == ImageMode.HSV)
        )
    if name == 'std_shift':
        return batched_std_shift(
            images, _field(configs, 'scale'),
            channels=_uniform(configs, 'channels'),
        )
    if name == 'boundary_equalization':
        return batched_boundary_equalization(
            images, channels=_uniform(configs, 'channels')
        )
    if name == 'histogram_equalization':
        return batched_histogram_equalization(
            images, channels=_uniform(configs, 'channels')
        )
    if name == 'complement':
        ltes = _field(configs, 'enable_threshold_lte')
        thresholds = _field(configs, 'threshold')
        if all(t is None for t in thresholds):
            thresholds = None
        else:
            # None -> sentinel making the gate always true (lte gates on
            # x<=t, otherwise on t<=x).
            thresholds = [
                t if t is not None else (255 if lte else 0)
                for t, lte in zip(thresholds, ltes)
            ]
        return batched_complement(
            images,
            thresholds,
            enable_threshold_ltes=ltes,
            channels=_uniform(configs, 'channels'),
        )
    if name == 'posterization':
        return batched_posterization(
            images, _field(configs, 'num_bits'),
            channels=_uniform(configs, 'channels'),
        )
    if name == 'color_balance':
        return batched_color_balance(images, _field(configs, 'ratio'))
    if name == 'channel_permutation':
        # Per-element this samples a permutation from the rng; the batched
        # form takes it from the key for determinism.
        perms = jax.vmap(
            lambda k: jax.random.permutation(k, images.shape[-1])
        )(jax.random.split(key, n))
        return batched_channel_permutation(images, np.asarray(perms))

    if name == 'gaussion_noise':
        return batched_gaussion_noise(images, _field(configs, 'std'), key)
    if name == 'poisson_noise':
        return batched_poisson_noise(images, key)
    if name == 'impulse_noise':
        return batched_impulse_noise(
            images,
            _field(configs, 'prob_salt'),
            _field(configs, 'prob_pepper'),
            key,
        )
    if name == 'speckle_noise':
        return batched_speckle_noise(images, _field(configs, 'std'), key)

    if name == 'jpeg_quality':
        return batched_jpeg_quality(images, _field(configs, 'quality'))
    if name == 'pixelation':
        arrays, _static = _prep_pixelation(configs, images.shape, key)
        return _apply_pixelation_traced(
            images, key, {k: jnp.asarray(v) for k, v in arrays.items()}, ()
        )
    if name == 'fog':
        return batched_fog(
            images,
            _field(configs, 'roughness'),
            key,
            fog_rgb=np.asarray(_field(configs, 'fog_rgb'), np.float32),
            ratio_maxs=np.asarray(_field(configs, 'ratio_max'), np.float32),
            ratio_mins=np.asarray(_field(configs, 'ratio_min'), np.float32),
        )

    if name == 'gaussian_blur':
        return batched_gaussian_blur(images, _field(configs, 'sigma'))
    if name == 'defocus_blur':
        return batched_defocus_blur(images, _field(configs, 'radius'))
    if name == 'motion_blur':
        return batched_motion_blur(
            images, _field(configs, 'radius'), _field(configs, 'angle')
        )
    if name == 'zoom_in_blur':
        arrays, _static = _prep_zoom(configs, images.shape, key)
        return _apply_zoom_traced(
            images, key, {k: jnp.asarray(v) for k, v in arrays.items()}, ()
        )

    if name == 'glass_blur':
        rng = np.random.default_rng(int(jax.random.randint(key, (), 0, 2**31 - 1)))
        return batched_glass_blur(
            images,
            _field(configs, 'sigma'),
            _field(configs, 'delta'),
            _field(configs, 'loop'),
            rng,
        )

    if name == 'line_streak':
        return batched_line_streak(images, configs)
    if name == 'rectangle_streak':
        return batched_rectangle_streak(images, configs)
    if name == 'ellipse_streak':
        return batched_ellipse_streak(images, configs)

    raise NotImplementedError(
        f'{name}: not available on the batched device path'
    )


# ---------------------------------------------------------------------------
# Compiled dispatch: ONE jitted call per (name, static-signature).
#
# The plain dispatch above executes eagerly — dozens of small device ops
# per apply, each its own dispatch.  Here every distortion
# splits into a host PREP (configs -> numpy param arrays + a hashable
# static signature: channel subsets, kernel widths, clip-vs-cycle) and a
# traced APPLY over (images, key, arrays); the jitted apply is cached per
# (name, static), so a steady-state batch pays one dispatch per
# distortion regardless of parameter draws.
# ---------------------------------------------------------------------------


def _chan(configs):
    channels = _uniform(configs, 'channels')
    return tuple(channels) if channels is not None else None


def _chan_gate3(channels) -> np.ndarray:
    """Per-channel 0/1 gate for a channels subset (None -> all)."""
    gate = np.zeros(3, dtype=np.float32)
    if channels is None:
        gate[:] = 1.0
    else:
        gate[list(channels)] = 1.0
    return gate


def _f32(values):
    return np.asarray(values, dtype=np.float32)


def _prep_mean_shift(configs, shape, key):
    deltas = _field(configs, 'delta')
    thresholds = _field(configs, 'threshold')
    arrays = {'deltas': _f32(deltas)}
    has_thresholds = not all(t is None for t in thresholds)
    if has_thresholds:
        arrays['thresholds'] = _f32([
            t if t is not None else (255 if d > 0 else 0)
            for t, d in zip(thresholds, deltas)
        ])
    return arrays, (_chan(configs), _uniform(configs, 'oob_behavior'),
                    has_thresholds)


def _apply_mean_shift(images, key, arrays, static):
    channels, oob, has_thresholds = static
    return batched_mean_shift(
        images, arrays['deltas'],
        arrays['thresholds'] if has_thresholds else None,
        channels=channels, oob_behavior=oob,
    )


def _prep_complement(configs, shape, key):
    ltes = _field(configs, 'enable_threshold_lte')
    thresholds = _field(configs, 'threshold')
    has_thresholds = not all(t is None for t in thresholds)
    arrays = {}
    if has_thresholds:
        arrays['thresholds'] = _f32([
            t if t is not None else (255 if lte else 0)
            for t, lte in zip(thresholds, ltes)
        ])
        arrays['ltes'] = np.asarray(ltes, dtype=bool)
    return arrays, (_chan(configs), has_thresholds)


def _apply_complement(images, key, arrays, static):
    channels, has_thresholds = static
    if not has_thresholds:
        return batched_complement(images, None, channels=channels)
    return batched_complement(
        images, arrays['thresholds'],
        enable_threshold_ltes=arrays['ltes'], channels=channels,
    )


def _prep_brightness(configs, shape, key):
    from ..element import ImageMode

    mode = _uniform(configs, 'intermediate_image_mode')
    return ({'deltas': _f32(_field(configs, 'delta'))},
            (mode == ImageMode.HSV,))


def _prep_jpeg(configs, shape, key):
    qualities = _field(configs, 'quality')
    luma = np.stack([
        _quality_scaled_table(_LUMA_QTABLE, int(q)) for q in qualities
    ]).astype(np.int32)
    chroma = np.stack([
        _quality_scaled_table(_CHROMA_QTABLE, int(q)) for q in qualities
    ]).astype(np.int32)
    return {'luma': luma, 'chroma': chroma}, ()


def _apply_jpeg(images, key, arrays, static):
    from ..ops.jpeg_exact import jpeg_roundtrip_exact_jnp

    out = jax.vmap(jpeg_roundtrip_exact_jnp)(
        images[..., ::-1], arrays['luma'], arrays['chroma'],
    )
    return out[..., ::-1]


def _prep_fog(configs, shape, key):
    # fog_rgb rides as a traced (N, 3) array: as a static it keyed a
    # fresh compiled program on every drawn color (unbounded compile set
    # across randomized batches — the round-4 steady-state leak).
    return ({
        'roughnesses': _f32(_field(configs, 'roughness')),
        'rmax': _f32(_field(configs, 'ratio_max')),
        'rmin': _f32(_field(configs, 'ratio_min')),
        'fog_rgb': np.asarray(_field(configs, 'fog_rgb'), np.float32),
    }, ())


def _apply_fog(images, key, arrays, static):
    return batched_fog(
        images, arrays['roughnesses'], key,
        fog_rgb=arrays['fog_rgb'],
        ratio_maxs=arrays['rmax'], ratio_mins=arrays['rmin'],
    )


def _gaussian_kernels(sigmas):
    kernels = []
    for sigma in np.asarray(sigmas):
        ksize = estimate_gaussian_kernel_size(float(sigma))
        k1 = blur_ops.gaussian_kernel1d(float(sigma), ksize)
        kernels.append(np.outer(k1, k1))
    return kernels


def _prep_gaussian_blur(configs, shape, key):
    kernels = _gaussian_kernels(_field(configs, 'sigma'))
    return {'kernels': np.asarray(_padded_kernels(kernels))}, ()


def _prep_defocus_blur(configs, shape, key):
    kernels = []
    for radius in _field(configs, 'radius'):
        radius = int(radius)
        size = 2 * radius + 1
        coords = np.arange(size) - radius
        xs, ys = np.meshgrid(coords, coords)
        kernel = ((xs**2 + ys**2) <= radius**2).astype(np.float32)
        kernels.append(kernel / kernel.sum())
    return {'kernels': np.asarray(_padded_kernels(kernels))}, ()


def _prep_motion_blur(configs, shape, key):
    kernels = []
    for radius, angle in zip(_field(configs, 'radius'),
                             _field(configs, 'angle')):
        ksize = 2 * int(radius) + 1
        kernel = blur_ops.motion_line_kernel(ksize, -(float(angle) % 360))
        kernels.append(kernel / max(kernel.sum(), 1e-6))
    return {'kernels': np.asarray(_padded_kernels(kernels))}, ()


def _apply_filter2d(images, key, arrays, static):
    return _batched_filter2d(images, arrays['kernels'])


def _prep_glass_blur(configs, shape, seed):
    kernels = _gaussian_kernels(_field(configs, 'sigma'))
    deltas = np.asarray(_field(configs, 'delta'), np.int32)
    loops = np.asarray(_field(configs, 'loop'), np.int32)
    dmax = int(deltas.max())
    lmax = int(loops.max())
    if dmax <= 2 and lmax <= 8:
        return {
            'kernels': np.asarray(_padded_kernels(kernels)),
            'deltas': deltas,
            'loops': loops,
        }, ('rolls', dmax, 4 if lmax <= 4 else 8)

    # Arbitrary delta/loop: host-built permutation + device gather (the
    # gather lowers ~40x off roofline — only the long-tail configs pay).
    from .distortion.photometric.blur import build_glass_blur_permutation

    n, h, w = shape[:3]
    rng = np.random.default_rng(int(seed) & 0x7FFFFFFF)
    flat_idx = np.empty((n, h, w), dtype=np.int32)
    for i, cfg in enumerate(configs):
        pos_y, pos_x = build_glass_blur_permutation(
            (h, w), int(cfg.delta), int(cfg.loop), rng
        )
        flat_idx[i] = pos_y * w + pos_x
    return {
        'kernels': np.asarray(_padded_kernels(kernels)),
        'flat_idx': flat_idx.reshape(n, h * w),
    }, ('gather',)


def _glass_blur_rolls(x, key, deltas, loops, dmax: int, lmax: int):
    """Iterated lattice swaps as masked ROLLS (no per-pixel gather).

    Each reference iteration swaps a (2d+1)-strided lattice of pixels
    with a jittered neighbor within +-d (blur.py
    build_glass_blur_permutation semantics).  Lattice spacing makes the
    swap pairs disjoint, so each (dy, dx) jitter class applies as two
    wrap-free rolls under its class mask — (2*dmax+1)^2-1 classes per
    iteration instead of a full-image gather (~40x off roofline).  Jitter
    draws come from the traced key (glass blur is rng-consuming:
    distributional parity, like the noise ops).  Border centers whose
    target would leave the canvas skip their swap (the reference clips
    the target, a border-only difference)."""
    n, h, w = x.shape[:3]
    py = jnp.arange(h)[None, :, None]
    px = jnp.arange(w)[None, None, :]
    d = deltas[:, None, None]
    stride = 2 * d + 1
    loops_g = loops[:, None, None]
    span = 2 * dmax + 1

    # The iteration loop runs as lax.fori_loop (one compiled body instead
    # of loop_max copies — the fully unrolled form took XLA tens of
    # minutes to compile); the (2*dmax+1)^2 - 1 jitter
    # classes unroll INSIDE the body with static roll shifts (cheap
    # lowering, dmax <= 2).
    del span

    def iteration(it, x):
        ko, kjy, kjx = jax.random.split(jax.random.fold_in(key, it), 3)
        offs = jax.random.randint(ko, (2, n, 1, 1), 0, 1 << 30)
        off_y = offs[0] % stride
        off_x = offs[1] % stride
        jy = jax.random.randint(kjy, (n, h, w), 0, 1 << 30) % stride - d
        jx = jax.random.randint(kjx, (n, h, w), 0, 1 << 30) % stride - d
        lat = (
            (py >= off_y) & (py < h - d) & ((py - off_y) % stride == 0)
            & (px >= off_x) & (px < w - d) & ((px - off_x) % stride == 0)
            & (it < loops_g)
        )
        for dy in range(-dmax, dmax + 1):
            for dx in range(-dmax, dmax + 1):
                if dy == 0 and dx == 0:
                    continue
                m_c = (
                    lat & (jy == dy) & (jx == dx)
                    & (py + dy >= 0) & (py + dy <= h - 1)
                    & (px + dx >= 0) & (px + dx <= w - 1)
                )
                m_t = jnp.roll(m_c, (dy, dx), (1, 2))
                fwd = jnp.roll(x, (-dy, -dx), (1, 2))
                bwd = jnp.roll(x, (dy, dx), (1, 2))
                x = jnp.where(
                    m_c[..., None], fwd,
                    jnp.where(m_t[..., None], bwd, x),
                )
        return x

    return jax.lax.fori_loop(0, lmax, iteration, x)


def _apply_glass_blur(images, key, arrays, static):
    blurred = _batched_filter2d(images, arrays['kernels'])
    if static and static[0] == 'rolls':
        return _glass_blur_rolls(
            blurred, key, arrays['deltas'], arrays['loops'],
            static[1], static[2],
        )
    n, h, w = images.shape[:3]

    def permute_one(img, idx):
        return img.reshape(h * w, -1)[idx].reshape(h, w, -1)

    return jax.vmap(permute_one)(blurred, arrays['flat_idx'])


def _dash_gate(length: int, dash_thickness, dash_gap):
    """(N, length) bool, True where the dash gap blanks a row/column
    (traced twin of streak._dash_rows; zero dash params -> no blanking)."""
    idx = jnp.arange(length, dtype=jnp.float32)[None, :]
    period = jnp.maximum(dash_thickness + dash_gap, 1.0)[:, None]
    gated = jnp.mod(idx, period) < dash_gap[:, None]
    enabled = ((dash_thickness > 0) & (dash_gap > 0))[:, None]
    return gated & enabled


def _prep_line_streak(configs, shape, key):
    return {
        'thickness': _f32(_field(configs, 'thickness')),
        'gap': _f32(_field(configs, 'gap')),
        'dash_thickness': _f32(_field(configs, 'dash_thickness')),
        'dash_gap': _f32(_field(configs, 'dash_gap')),
        'enable_vert': np.asarray(_field(configs, 'enable_vert'), bool),
        'enable_hori': np.asarray(_field(configs, 'enable_hori'), bool),
        'colors': _f32(_field(configs, 'color')),
        'alphas': _f32(_field(configs, 'alpha')),
    }, ()


def _apply_line_streak(images, key, arrays, static):
    """Periodic line stencils generated ON DEVICE from iota arithmetic —
    no host mask build, no (N, H, W) upload."""
    n, h, w = images.shape[:3]
    period = jnp.maximum(arrays['thickness'] + arrays['gap'], 1.0)
    t = arrays['thickness']

    cols = jnp.arange(w, dtype=jnp.float32)[None, :]
    rows = jnp.arange(h, dtype=jnp.float32)[None, :]
    vert_cols = (jnp.mod(cols, period[:, None]) < t[:, None])
    hori_rows = (jnp.mod(rows, period[:, None]) < t[:, None])
    dash_r = _dash_gate(h, arrays['dash_thickness'], arrays['dash_gap'])
    dash_c = _dash_gate(w, arrays['dash_thickness'], arrays['dash_gap'])

    vert = (
        vert_cols[:, None, :] & ~dash_r[:, :, None]
        & arrays['enable_vert'][:, None, None]
    )
    hori = (
        hori_rows[:, :, None] & ~dash_c[:, None, :]
        & arrays['enable_hori'][:, None, None]
    )
    out = _blend_streak_masks(
        images, vert.astype(jnp.float32), arrays['colors'], arrays['alphas']
    )
    return _blend_streak_masks(
        out, hori.astype(jnp.float32), arrays['colors'], arrays['alphas']
    )


def _concentric_box_array(configs, shape, max_boxes_round: int = 8):
    """(N, B, 4) float32 concentric frames (up, down, left, right), padded
    with degenerate rows; B rounds up so compile count stays bounded."""
    from .distortion.photometric.streak import concentric_boxes

    n, h, w = shape[:3]
    per_sample = []
    for cfg in configs:
        aspect = cfg.aspect_ratio if cfg.aspect_ratio is not None else w / h
        boxes = concentric_boxes(h, w, aspect, cfg.short_side_min,
                                 cfg.short_side_step)
        per_sample.append([
            (b.up, b.down, b.left, b.right) for b in boxes
        ])
    b_max = max((len(b) for b in per_sample), default=1)
    # Power-of-two padding (min one round): the box count is a compiled
    # static via the scan length.
    padded = max_boxes_round
    while padded < b_max:
        padded *= 2
    b_max = padded
    out = np.full((n, b_max, 4), -1e6, dtype=np.float32)
    for i, boxes in enumerate(per_sample):
        if boxes:
            out[i, :len(boxes)] = boxes
    return out


def _prep_rectangle_streak(configs, shape, key):
    return {
        'boxes': _concentric_box_array(configs, shape),
        'thickness': _f32(_field(configs, 'thickness')),
        'dash_thickness': _f32(_field(configs, 'dash_thickness')),
        'dash_gap': _f32(_field(configs, 'dash_gap')),
        'colors': _f32(_field(configs, 'color')),
        'alphas': _f32(_field(configs, 'alpha')),
    }, ()


def _apply_rectangle_streak(images, key, arrays, static):
    """Concentric frame stencils ON DEVICE: a lax.scan over the (padded)
    box list accumulates the vertical/horizontal bar masks."""
    n, h, w = images.shape[:3]
    t = arrays['thickness'][:, None, None]
    ys = jnp.arange(h, dtype=jnp.float32)[None, :, None]
    xs = jnp.arange(w, dtype=jnp.float32)[None, None, :]

    def body(carry, box):
        vert_acc, hori_acc = carry
        up = box[:, 0][:, None, None]
        down = box[:, 1][:, None, None]
        left = box[:, 2][:, None, None]
        right = box[:, 3][:, None, None]
        in_up = down - t + 1.0
        in_down = up + t - 1.0
        in_left = right - t + 1.0
        in_right = left + t - 1.0
        y_band = (ys >= up) & (ys <= down)
        vert = y_band & (
            ((xs >= left) & (xs <= in_right))
            | ((xs >= in_left) & (xs <= right))
        )
        x_core = (xs >= in_right + 1.0) & (xs <= in_left - 1.0)
        hori = x_core & (
            ((ys >= up) & (ys <= in_down))
            | ((ys >= in_up) & (ys <= down))
        )
        return (vert_acc | vert, hori_acc | hori), None

    zero = jnp.zeros((n, h, w), dtype=bool)
    (vert, hori), _ = jax.lax.scan(
        body, (zero, zero), jnp.transpose(arrays['boxes'], (1, 0, 2))
    )
    dash_r = _dash_gate(h, arrays['dash_thickness'], arrays['dash_gap'])
    dash_c = _dash_gate(w, arrays['dash_thickness'], arrays['dash_gap'])
    mask = (vert & ~dash_r[:, :, None]) | (hori & ~dash_c[:, None, :])
    return _blend_streak_masks(
        images, mask.astype(jnp.float32), arrays['colors'], arrays['alphas']
    )


def _prep_ellipse_streak(configs, shape, key):
    """Host-rasterized ring stencils (cv2-exact integer rasterization,
    ops/cvraster.py via ellipse_ring_stencil) uploaded as jit arguments —
    the device implicit-band form diverged from the cv pixel sets the
    per-element path now reproduces.  Member sub-batches keep the upload
    small (~0.4 MB per member at 640^2)."""
    from .distortion.photometric.streak import (
        concentric_boxes,
        ellipse_ring_stencil,
    )

    n, h, w = shape[:3]
    stencils = np.zeros((len(configs), h, w), dtype=np.uint8)
    for i, cfg in enumerate(configs):
        aspect = cfg.aspect_ratio if cfg.aspect_ratio is not None else w / h
        boxes = concentric_boxes(
            h, w, aspect, cfg.short_side_min, cfg.short_side_step
        )
        stencils[i] = ellipse_ring_stencil(
            (h, w), (w // 2, h // 2),
            [(b.width // 2, b.height // 2) for b in boxes],
            int(cfg.thickness),
        )
    return {
        'stencil': stencils,
        'colors': _f32(_field(configs, 'color')),
        'alphas': _f32(_field(configs, 'alpha')),
    }, ()


def _apply_ellipse_streak(images, key, arrays, static):
    return _blend_streak_masks(
        images, arrays['stencil'].astype(jnp.float32),
        arrays['colors'], arrays['alphas'],
    )


def _apply_channel_permutation(images, key, arrays, static):
    n = images.shape[0]
    perms = jax.vmap(
        lambda k: jax.random.permutation(k, images.shape[-1])
    )(jax.random.split(key, n))
    return batched_channel_permutation(images, perms)


def _field_prep(field_names, *statics_fields):
    """Prep factory: per-sample float arrays + uniform static fields."""
    def prep(configs, shape, key):
        arrays = {
            name: _f32(_field(configs, name)) for name in field_names
        }
        static = tuple(
            tuple(v) if isinstance(v, (list, tuple)) else v
            for v in (
                _uniform(configs, f) for f in statics_fields
            )
        )
        return arrays, static
    return prep



# ---------------------------------------------------------------------------
# Shape-changing photometric ops with TRACED per-sample parameters.
#
# pixelation / zoom_in_blur change an intermediate canvas per draw; naive
# batching compiles a fresh program per (ratio, step) draw — a perpetual
# compile leak.  Both ops are separable resampling
# chains, so the per-sample resize matrices build ON DEVICE from traced
# integer sizes and the compiled program is one per image shape.
# ---------------------------------------------------------------------------


def _nearest_up_linear_down_weights(n: int, rn, dtype=jnp.float32):
    """(n, n) weights of LINEAR-downsample-to-rn composed with NEAREST-
    upsample-back (the pixelation map), traced ``rn``.

    Tap definitions mirror ops/resize_taps.py: NEAREST src = floor(i *
    rn / n); LINEAR centers (a + 0.5) * (n / rn) - 0.5 with edge clipping.
    """
    i = jnp.arange(n)
    a = jnp.clip((i * rn) // n, 0, rn - 1)          # NEAREST up indices
    scale = n / rn.astype(dtype)
    c = (a.astype(dtype) + 0.5) * scale - 0.5       # LINEAR down centers
    base = jnp.floor(c)
    w1 = (c - base)[:, None]
    idx0 = jnp.clip(base.astype(jnp.int32), 0, n - 1)[:, None]
    idx1 = jnp.clip(base.astype(jnp.int32) + 1, 0, n - 1)[:, None]
    iota = jnp.arange(n)[None, :]
    return (
        (iota == idx0).astype(dtype) * (1.0 - w1)
        + (iota == idx1).astype(dtype) * w1
    )


def _apply_pixelation_traced(images, key, arrays, static):
    n, h, w = images.shape[:3]
    r_rows = jax.vmap(
        lambda rh: _nearest_up_linear_down_weights(h, rh)
    )(arrays['rh'])                                   # (N, H, H)
    r_cols = jax.vmap(
        lambda rw: _nearest_up_linear_down_weights(w, rw)
    )(arrays['rw'])                                   # (N, W, W)
    x = images.astype(jnp.float32)
    x = jnp.einsum('nis,nswc->niwc', r_rows, x,
                   preferred_element_type=jnp.float32,
                   precision=lax.Precision.HIGHEST)
    x = jnp.einsum('njs,nisc->nijc', r_cols, x,
                   preferred_element_type=jnp.float32,
                   precision=lax.Precision.HIGHEST)
    return _finish(x)


def _prep_pixelation(configs, shape, key):
    n, h, w = shape[:3]
    rh = np.asarray([
        max(1, round(h * cfg.ratio)) for cfg in configs
    ], dtype=np.int32)
    rw = np.asarray([
        max(1, round(w * cfg.ratio)) for cfg in configs
    ], dtype=np.int32)
    return {'rh': rh, 'rw': rw}, ()


_ZOOM_MAX_STEPS = 24


def _cubic_crop_weights(n: int, rn, dtype=jnp.float32):
    """(n, n) weights of CUBIC-upsample-to-rn composed with the center
    crop back to n (one zoom_in_blur step), traced ``rn``."""
    up = (rn - n) // 2
    i = jnp.arange(n) + up                           # rows of the zoomed canvas
    scale = n / rn.astype(dtype)
    c = (i.astype(dtype) + 0.5) * scale - 0.5
    base = jnp.floor(c)
    iota = jnp.arange(n)[None, :]
    acc = jnp.zeros((n, n), dtype)
    a = -0.75
    for tap in (-1, 0, 1, 2):
        idx = base.astype(jnp.int32) + tap
        dist = jnp.abs(c - idx.astype(dtype))
        d2 = dist * dist
        d3 = d2 * dist
        wt = jnp.where(
            dist <= 1.0,
            (a + 2.0) * d3 - (a + 3.0) * d2 + 1.0,
            jnp.where(
                dist < 2.0,
                a * d3 - 5.0 * a * d2 + 8.0 * a * dist - 4.0 * a,
                0.0,
            ),
        )
        clipped = jnp.clip(idx, 0, n - 1)[:, None]
        acc = acc + (iota == clipped).astype(dtype) * wt[:, None]
    return acc / acc.sum(axis=1, keepdims=True)      # cv2 row normalization


def _apply_zoom_traced(images, key, arrays, static):
    n, h, w = images.shape[:3]
    x = images.astype(jnp.float32)
    acc = x
    for k in range(_ZOOM_MAX_STEPS):
        rh = arrays['rhs'][:, k]
        rw = arrays['rws'][:, k]
        rows = jax.vmap(lambda r: _cubic_crop_weights(h, r))(rh)
        cols = jax.vmap(lambda r: _cubic_crop_weights(w, r))(rw)
        z = jnp.einsum('nis,nswc->niwc', rows, x,
                       preferred_element_type=jnp.float32,
                       precision=lax.Precision.HIGHEST)
        z = jnp.einsum('njs,nisc->nijc', cols, z,
                       preferred_element_type=jnp.float32,
                       precision=lax.Precision.HIGHEST)
        live = (k < arrays['count'])[:, None, None, None]
        acc = acc + jnp.where(live, z, 0.0)
    total = (arrays['count'] + 1).astype(jnp.float32)[:, None, None, None]
    alpha = arrays['alpha'][:, None, None, None]
    mixed = (1.0 - alpha) * x + alpha * jnp.round(acc / total)
    return _finish(mixed)


def _prep_zoom(configs, shape, key):
    n, h, w = shape[:3]
    rhs = np.full((len(configs), _ZOOM_MAX_STEPS), h, dtype=np.int32)
    rws = np.full((len(configs), _ZOOM_MAX_STEPS), w, dtype=np.int32)
    counts = np.zeros(len(configs), dtype=np.int32)
    for idx, cfg in enumerate(configs):
        zooms = np.arange(1 + cfg.step, 1 + cfg.ratio + cfg.step, cfg.step)
        if len(zooms) > _ZOOM_MAX_STEPS:
            # The traced program unrolls _ZOOM_MAX_STEPS stages; deeper
            # ladders would silently diverge from the reference's full
            # average — no silent caps (the policy's level-10 maximum is
            # ratio 0.4 / step 0.02 = 20 steps, so this only fires on
            # hand-written extreme configs).
            logger.warning(
                'zoom_in_blur: ratio/step = %d zoom levels exceeds the '
                'traced maximum %d; truncating (visually equivalent, not '
                'reference-exact)', len(zooms), _ZOOM_MAX_STEPS,
            )
            zooms = zooms[:_ZOOM_MAX_STEPS]
        counts[idx] = len(zooms)
        for k, z in enumerate(zooms):
            rhs[idx, k] = round(h * z)
            rws[idx, k] = round(w * z)
    return {
        'rhs': rhs, 'rws': rws, 'count': counts,
        'alpha': _f32(_field(configs, 'alpha')),
    }, ()


_COMPILED_CATALOG = {
    'mean_shift': (_prep_mean_shift, _apply_mean_shift),
    'color_shift': (
        _field_prep(('delta',)),
        lambda images, key, arrays, static:
            batched_color_shift(images, arrays['delta']),
    ),
    'brightness_shift': (
        _prep_brightness,
        lambda images, key, arrays, static:
            batched_brightness_shift(images, arrays['deltas'],
                                     use_hsv=static[0]),
    ),
    'std_shift': (
        _field_prep(('scale',), 'channels'),
        lambda images, key, arrays, static:
            batched_std_shift(images, arrays['scale'], channels=static[0]),
    ),
    'boundary_equalization': (
        _field_prep((), 'channels'),
        lambda images, key, arrays, static:
            batched_boundary_equalization(images, channels=static[0]),
    ),
    # Channels ride as a traced per-sample gate: as statics they keyed 8
    # compiled programs (every subset of {0,1,2} plus None) that trickled
    # in across randomized batches — a round-4 steady-state compile leak.
    # Equalizing all 3 channels and gating costs ~1.5x the arithmetic of
    # the average subset on the rare samples that draw this op.
    'histogram_equalization': (
        lambda configs, shape, key: ({
            'chan_gate': np.stack([
                _chan_gate3(getattr(c, 'channels', None)) for c in configs
            ]),
        }, ()),
        lambda images, key, arrays, static: jnp.where(
            arrays['chan_gate'][:, None, None, :] > 0,
            batched_histogram_equalization(images),
            images,
        ),
    ),
    'complement': (_prep_complement, _apply_complement),
    'posterization': (
        lambda configs, shape, key: (
            {'num_bits': np.asarray(_field(configs, 'num_bits'), np.int32)},
            (_chan(configs),),
        ),
        lambda images, key, arrays, static:
            batched_posterization(images, arrays['num_bits'],
                                  channels=static[0]),
    ),
    'color_balance': (
        _field_prep(('ratio',)),
        lambda images, key, arrays, static:
            batched_color_balance(images, arrays['ratio']),
    ),
    'channel_permutation': (
        _field_prep(()), _apply_channel_permutation,
    ),
    'gaussion_noise': (
        _field_prep(('std',)),
        lambda images, key, arrays, static:
            batched_gaussion_noise(images, arrays['std'], key),
    ),
    'poisson_noise': (
        _field_prep(()),
        lambda images, key, arrays, static:
            batched_poisson_noise(images, key),
    ),
    'impulse_noise': (
        _field_prep(('prob_salt', 'prob_pepper')),
        lambda images, key, arrays, static:
            batched_impulse_noise(images, arrays['prob_salt'],
                                  arrays['prob_pepper'], key),
    ),
    'speckle_noise': (
        _field_prep(('std',)),
        lambda images, key, arrays, static:
            batched_speckle_noise(images, arrays['std'], key),
    ),
    'jpeg_quality': (_prep_jpeg, _apply_jpeg),
    'pixelation': (_prep_pixelation, _apply_pixelation_traced),
    'fog': (_prep_fog, _apply_fog),
    'gaussian_blur': (_prep_gaussian_blur, _apply_filter2d),
    'defocus_blur': (_prep_defocus_blur, _apply_filter2d),
    'motion_blur': (_prep_motion_blur, _apply_filter2d),
    'glass_blur': (_prep_glass_blur, _apply_glass_blur),
    'zoom_in_blur': (_prep_zoom, _apply_zoom_traced),
    'line_streak': (_prep_line_streak, _apply_line_streak),
    'rectangle_streak': (_prep_rectangle_streak, _apply_rectangle_streak),
    'ellipse_streak': (_prep_ellipse_streak, _apply_ellipse_streak),
}

_COMPILED_FNS = {}


def _compiled_fn(name: str, static: tuple, mode: str = 'full'):
    """One jitted program per (name, static, mode).

    ``mode`` folds the member-selection plumbing INTO the program, so no
    separate eager op dispatches:
      'full'   — apply to the whole batch;
      'masked' — apply to the whole batch, where-select members;
      'sub'    — gather a member sub-batch, apply, scatter back.
    The rng key derives from a traced uint32 seed inside the program (no
    eager fold_in chain).
    """
    cache_key = (name, static, mode)
    fn = _COMPILED_FNS.get(cache_key)
    if fn is None:
        apply = _COMPILED_CATALOG[name][1]

        if mode == 'full':
            def wrapped(images, seed, arrays, _apply=apply, _static=static):
                key = jax.random.PRNGKey(seed)
                return _apply(images, key, arrays, _static)
        elif mode == 'masked':
            def wrapped(images, seed, arrays, selected,
                        _apply=apply, _static=static):
                key = jax.random.PRNGKey(seed)
                distorted = _apply(images, key, arrays, _static)
                gate = selected.astype(jnp.bool_)[:, None, None, None]
                return jnp.where(gate, distorted, images)
        else:
            def wrapped(images, seed, arrays, idx, scatter_idx,
                        _apply=apply, _static=static):
                # scatter_idx: idx with pad slots out of bounds (dropped)
                # — rng-bearing ops compute different values in duplicate
                # pad slots, and a duplicate scatter would race them.
                key = jax.random.PRNGKey(seed)
                sub = jnp.take(images, idx, axis=0)
                res = _apply(sub, key, arrays, _static)
                return images.at[scatter_idx].set(res, mode='drop')

        fn = jax.jit(wrapped)
        _COMPILED_FNS[cache_key] = fn
    return fn


_SUB_BUCKET = 8


def batch_distort_members(name: str, group, images, seed: int):
    """Apply one distortion to member (sample_idx, config) pairs in ONE
    jitted dispatch (selection plumbing fused into the program).

    Majority draws apply full-batch with a where-select; minority draws
    gather an 8-slot sub-batch and scatter back.
    """
    n = images.shape[0]
    idx = [sample_idx for sample_idx, _ in group]
    prep, _ = _COMPILED_CATALOG[name]
    seed_u32 = np.uint32(int(seed) & 0xFFFFFFFF)

    if len(idx) == n:
        ordered = [None] * n
        for sample_idx, config in group:
            ordered[sample_idx] = config
        arrays, static = prep(ordered, images.shape, seed)
        return _compiled_fn(name, static, 'full')(images, seed_u32, arrays)

    if len(idx) > _SUB_BUCKET:
        configs = [group[0][1]] * n
        for sample_idx, config in group:
            configs[sample_idx] = config
        arrays, static = prep(configs, images.shape, seed)
        selected = np.zeros(n, dtype=np.float32)
        selected[idx] = 1.0
        return _compiled_fn(name, static, 'masked')(
            images, seed_u32, arrays, selected
        )

    bucket = min(_SUB_BUCKET, n)
    idx_pad = idx + [idx[0]] * (bucket - len(idx))
    scat_pad = idx + [n] * (bucket - len(idx))
    configs = [group[0][1]] * bucket
    for slot, (sample_idx, config) in enumerate(group):
        configs[slot] = config
    arrays, static = prep(
        configs, (bucket,) + tuple(images.shape[1:]), seed
    )
    return _compiled_fn(name, static, 'sub')(
        images, seed_u32, arrays, np.asarray(idx_pad, dtype=np.int32),
        np.asarray(scat_pad, dtype=np.int32),
    )


def batch_distort_images_compiled(name: str, configs: Sequence, images,
                                  key=None, seed=None):
    """batch_distort_images, but ONE jitted dispatch per apply.

    Numeric per-sample params travel as jit arguments (no retrace across
    draws); program-structure params form the compile-cache key.
    """
    n = images.shape[0]
    assert len(configs) == n
    if seed is None:
        seed = 0 if key is None else int(
            np.asarray(jax.random.key_data(key)).ravel()[-1]
        )
    if key is None:
        key = jax.random.PRNGKey(0)
    prep, _ = _COMPILED_CATALOG[name]
    arrays, static = prep(configs, images.shape, seed)
    fn = _compiled_fn(name, static, 'full')
    return fn(images, np.uint32(seed), arrays)
