"""One-program photometric rounds: the catalog traced once, per-sample op
selection by masked combine.

The dispatch in batched_random.py issues one compiled program per drawn
distortion name — correct, but a randomized batch triggers ~10-25
dispatches per round, each with its own host orchestration.  This module
is the SURVEY §7
design instead: ONE jitted program applies a whole round — every
mega-covered op computes over the batch and a per-sample select keeps the
drawn op's output:

    out[n] = op_{sel[n]}(out)[n]        (sel = -1 -> passthrough)

Per-sample parameters for ALL ops live in one fixed-shape table (zeros for
undrawn slots — their outputs are discarded by the select), so the program
compiles once per batch shape.  Channel subsets become per-channel gates
instead of static signatures.

Ops excluded from the mega program (applied via the per-name compiled
dispatch on a gathered member SUB-BATCH when drawn): the blurs (always-on
convolutions would dominate the round), rectangle/ellipse streaks (scanned
stencils), glass_blur (host-built permutation), pixelation and zoom_in_blur
(shape-changing statics), and the heavyweights — histogram_equalization,
jpeg_quality, fog and poisson_noise — whose cost only makes sense on the
few samples that drew them.  Exclusion preserves per-sample ordering: each round applies its
mega ops first, then the round's excluded draws by name.
"""
import functools
from typing import Dict, List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops import color as color_ops
from .batched import _blend_streak_masks, _dash_gate

# Order defines each op's selection index; append-only.
MEGA_NAMES: Tuple[str, ...] = (
    'mean_shift',
    'color_shift',
    'brightness_shift',
    'std_shift',
    'boundary_equalization',
    'complement',
    'posterization',
    'color_balance',
    'channel_permutation',
    'gaussion_noise',
    'impulse_noise',
    'speckle_noise',
    'line_streak',
    'gaussian_blur',
    'defocus_blur',
    'motion_blur',
)

# Filter blurs ride the mega round as ONE per-sample KxK convolution
# (identity kernels for non-members).  Draws whose kernel exceeds the
# static width fall back to the per-name dispatch.
_BLUR_K = 7
_MEGA_INDEX = {name: i for i, name in enumerate(MEGA_NAMES)}


def mega_covers(name: str, config=None) -> bool:
    if name not in _MEGA_INDEX:
        return False
    if config is None:
        return True
    if name == 'gaussian_blur':
        from .distortion.photometric.blur import (
            estimate_gaussian_kernel_size,
        )
        return estimate_gaussian_kernel_size(float(config.sigma)) <= _BLUR_K
    if name == 'defocus_blur':
        return 2 * int(config.radius) + 1 <= _BLUR_K
    if name == 'motion_blur':
        return 2 * int(config.radius) + 1 <= _BLUR_K
    return True


# ---------------------------------------------------------------------------
# Param table: one fixed-shape entry per field; zeros for undrawn slots.
# ---------------------------------------------------------------------------

_SCALAR_FIELDS = (
    'ms_delta', 'ms_thr', 'ms_cycle',
    'cs_delta',
    'bs_delta', 'bs_use_hsv',
    'ss_scale',
    'cp_thr', 'cp_lte',
    'cb_ratio',
    'gn_std', 'in_salt', 'in_pepper', 'sn_std',
    'lk_thickness', 'lk_gap', 'lk_dash_t', 'lk_dash_g',
    'lk_vert', 'lk_hori', 'lk_alpha',
)
_VEC3_FIELDS = ('ms_chan', 'ss_chan', 'be_chan', 'cp_chan',
                'po_chan', 'lk_color')


def _chan_gate(channels) -> np.ndarray:
    gate = np.zeros(3, dtype=np.float32)
    if channels is None:
        gate[:] = 1.0
    else:
        gate[list(channels)] = 1.0
    return gate


def build_round_params(n: int, members_by_name: Dict[str, list]):
    """(sel (N,), params dict) for one round; members_by_name maps a mega
    name to [(sample_idx, config)] drawn this round."""
    sel = np.full(n, -1, dtype=np.int32)
    p: Dict[str, np.ndarray] = {
        f: np.zeros(n, dtype=np.float32) for f in _SCALAR_FIELDS
    }
    for f in _VEC3_FIELDS:
        p[f] = np.zeros((n, 3), dtype=np.float32)
    p['po_bits'] = np.zeros(n, dtype=np.int32)
    p['bl_kernel'] = np.zeros((n, _BLUR_K, _BLUR_K), dtype=np.float32)
    p['bl_kernel'][:, _BLUR_K // 2, _BLUR_K // 2] = 1.0

    for name, members in members_by_name.items():
        idx = _MEGA_INDEX[name]
        for i, cfg in members:
            sel[i] = idx
            if name == 'mean_shift':
                p['ms_delta'][i] = cfg.delta
                if cfg.threshold is not None:
                    p['ms_thr'][i] = cfg.threshold
                else:
                    # Sentinel making the gate always-true for the delta's
                    # sign (threshold-off emulation).
                    p['ms_thr'][i] = 255.0 if cfg.delta > 0 else 0.0
                from .distortion.photometric.base import OutOfBoundBehavior
                p['ms_cycle'][i] = float(
                    cfg.oob_behavior == OutOfBoundBehavior.CYCLE
                )
                p['ms_chan'][i] = _chan_gate(cfg.channels)
            elif name == 'color_shift':
                p['cs_delta'][i] = cfg.delta
            elif name == 'brightness_shift':
                from ..element import ImageMode
                p['bs_delta'][i] = cfg.delta
                p['bs_use_hsv'][i] = float(
                    cfg.intermediate_image_mode == ImageMode.HSV
                )
            elif name == 'std_shift':
                p['ss_scale'][i] = cfg.scale
                p['ss_chan'][i] = _chan_gate(cfg.channels)
            elif name == 'boundary_equalization':
                p['be_chan'][i] = _chan_gate(cfg.channels)
            elif name == 'complement':
                if cfg.threshold is not None:
                    p['cp_thr'][i] = cfg.threshold
                else:
                    p['cp_thr'][i] = (
                        255.0 if cfg.enable_threshold_lte else 0.0
                    )
                p['cp_lte'][i] = float(cfg.enable_threshold_lte)
                p['cp_chan'][i] = _chan_gate(cfg.channels)
            elif name == 'posterization':
                p['po_bits'][i] = cfg.num_bits
                p['po_chan'][i] = _chan_gate(cfg.channels)
            elif name == 'color_balance':
                p['cb_ratio'][i] = cfg.ratio
            elif name == 'channel_permutation':
                pass  # permutation derives from the round key on device
            elif name == 'gaussion_noise':
                p['gn_std'][i] = cfg.std
            elif name == 'impulse_noise':
                p['in_salt'][i] = cfg.prob_salt
                p['in_pepper'][i] = cfg.prob_pepper
            elif name == 'speckle_noise':
                p['sn_std'][i] = cfg.std
            elif name in ('gaussian_blur', 'defocus_blur', 'motion_blur'):
                from ..ops import blur as blur_ops
                from .distortion.photometric.blur import (
                    estimate_gaussian_kernel_size,
                )
                if name == 'gaussian_blur':
                    ksize = estimate_gaussian_kernel_size(float(cfg.sigma))
                    k1 = blur_ops.gaussian_kernel1d(float(cfg.sigma), ksize)
                    kern = np.outer(k1, k1)
                elif name == 'defocus_blur':
                    radius = int(cfg.radius)
                    size = 2 * radius + 1
                    coords = np.arange(size) - radius
                    xs_, ys_ = np.meshgrid(coords, coords)
                    kern = (
                        (xs_**2 + ys_**2) <= radius**2
                    ).astype(np.float32)
                    kern = kern / kern.sum()
                else:
                    ksize = 2 * int(cfg.radius) + 1
                    kern = blur_ops.motion_line_kernel(
                        ksize, -(float(cfg.angle) % 360)
                    )
                    kern = kern / max(kern.sum(), 1e-6)
                off = (_BLUR_K - kern.shape[0]) // 2
                k_pad = np.zeros((_BLUR_K, _BLUR_K), dtype=np.float32)
                k_pad[off:off + kern.shape[0], off:off + kern.shape[1]] = kern
                p['bl_kernel'][i] = k_pad
            elif name == 'line_streak':
                p['lk_thickness'][i] = cfg.thickness
                p['lk_gap'][i] = cfg.gap
                p['lk_dash_t'][i] = cfg.dash_thickness
                p['lk_dash_g'][i] = cfg.dash_gap
                p['lk_vert'][i] = float(cfg.enable_vert)
                p['lk_hori'][i] = float(cfg.enable_hori)
                p['lk_alpha'][i] = cfg.alpha
                p['lk_color'][i] = np.asarray(cfg.color, dtype=np.float32)
            else:  # pragma: no cover - MEGA_NAMES drift guard
                raise AssertionError(name)
    return sel, p


# ---------------------------------------------------------------------------
# The traced round: every op computes, a per-sample select keeps one.
# ---------------------------------------------------------------------------


def _sel4(v):
    return v[:, None, None, None]


def _chan_mix(x_new, x_old, gate):
    """Per-channel gate (N, 3) over (N, H, W, 3) float results."""
    return jnp.where(gate[:, None, None, :] > 0.5, x_new, x_old)


# Each op reuses the SAME traced kernels as the per-name compiled dispatch
# (mechanism/batched.py), so outputs match that path bit for bit; only the
# channel-subset gating moves from a static signature to a traced mask.


def _op_mean_shift(x, p):
    from .batched import batched_mean_shift
    from .distortion.photometric.base import OutOfBoundBehavior

    xu8 = x.astype(jnp.uint8)
    clip = batched_mean_shift(
        xu8, p['ms_delta'], p['ms_thr'],
        oob_behavior=OutOfBoundBehavior.CLIP,
    ).astype(jnp.float32)
    cyc = batched_mean_shift(
        xu8, p['ms_delta'], p['ms_thr'],
        oob_behavior=OutOfBoundBehavior.CYCLE,
    ).astype(jnp.float32)
    out = jnp.where(_sel4(p['ms_cycle']) > 0.5, cyc, clip)
    return _chan_mix(out, x, p['ms_chan'])


def _op_color_shift(x, p):
    from .batched import batched_color_shift

    return batched_color_shift(
        x.astype(jnp.uint8), p['cs_delta']
    ).astype(jnp.float32)


def _op_brightness(x, p):
    from .batched import batched_brightness_shift

    xu8 = x.astype(jnp.uint8)
    hsl = batched_brightness_shift(
        xu8, p['bs_delta'], use_hsv=False
    ).astype(jnp.float32)
    hsv = batched_brightness_shift(
        xu8, p['bs_delta'], use_hsv=True
    ).astype(jnp.float32)
    return jnp.where(_sel4(p['bs_use_hsv']) > 0.5, hsv, hsl)


def _op_std_shift(x, p):
    from .batched import batched_std_shift

    out = batched_std_shift(
        x.astype(jnp.uint8), p['ss_scale']
    ).astype(jnp.float32)
    return _chan_mix(out, x, p['ss_chan'])


def _op_boundary_eq(x, p):
    from .batched import batched_boundary_equalization

    out = batched_boundary_equalization(
        x.astype(jnp.uint8)
    ).astype(jnp.float32)
    return _chan_mix(out, x, p['be_chan'])


def _op_complement(x, p):
    from .batched import batched_complement

    out = batched_complement(
        x.astype(jnp.uint8), p['cp_thr'],
        enable_threshold_ltes=p['cp_lte'] > 0.5,
    ).astype(jnp.float32)
    return _chan_mix(out, x, p['cp_chan'])


def _op_posterization(x, p):
    from .batched import batched_posterization

    out = batched_posterization(
        x.astype(jnp.uint8), p['po_bits']
    ).astype(jnp.float32)
    return _chan_mix(out, x, p['po_chan'])


def _op_color_balance(x, p):
    from .batched import batched_color_balance

    return batched_color_balance(
        x.astype(jnp.uint8), p['cb_ratio']
    ).astype(jnp.float32)


def _op_channel_permutation(x, p, key):
    from .batched import batched_channel_permutation

    n = x.shape[0]
    perms = jax.vmap(
        lambda k: jax.random.permutation(k, x.shape[-1])
    )(jax.random.split(key, n))
    return batched_channel_permutation(
        x.astype(jnp.uint8), perms
    ).astype(jnp.float32)


def _op_gauss_noise(x, p, key):
    from .batched import batched_gaussion_noise

    return batched_gaussion_noise(
        x.astype(jnp.uint8), p['gn_std'], key
    ).astype(jnp.float32)


def _op_impulse_noise(x, p, key):
    from .batched import batched_impulse_noise

    return batched_impulse_noise(
        x.astype(jnp.uint8), p['in_salt'], p['in_pepper'], key
    ).astype(jnp.float32)


def _op_speckle_noise(x, p, key):
    from .batched import batched_speckle_noise

    return batched_speckle_noise(
        x.astype(jnp.uint8), p['sn_std'], key
    ).astype(jnp.float32)


def _op_blur(x, p):
    from .batched import _batched_filter2d

    return _batched_filter2d(
        x.astype(jnp.uint8), p['bl_kernel']
    ).astype(jnp.float32)


def _op_line_streak(x, p):
    from .batched import _apply_line_streak

    arrays = {
        'thickness': p['lk_thickness'],
        'gap': p['lk_gap'],
        'dash_thickness': p['lk_dash_t'],
        'dash_gap': p['lk_dash_g'],
        'enable_vert': p['lk_vert'] > 0.5,
        'enable_hori': p['lk_hori'] > 0.5,
        'colors': p['lk_color'],
        'alphas': p['lk_alpha'],
    }
    return _apply_line_streak(
        x.astype(jnp.uint8), None, arrays, ()
    ).astype(jnp.float32)


def _mega_round_core(images, sel, params, seed):
    x = images.astype(jnp.float32)
    outs: List = []
    key_stream = jax.random.split(jax.random.PRNGKey(seed), 8)

    outs.append(_op_mean_shift(x, params))
    outs.append(_op_color_shift(x, params))
    outs.append(_op_brightness(x, params))
    outs.append(_op_std_shift(x, params))
    outs.append(_op_boundary_eq(x, params))
    outs.append(_op_complement(x, params))
    outs.append(_op_posterization(x, params))
    outs.append(_op_color_balance(x, params))
    outs.append(_op_channel_permutation(x, params, key_stream[0]))
    outs.append(_op_gauss_noise(x, params, key_stream[1]))
    outs.append(_op_impulse_noise(x, params, key_stream[3]))
    outs.append(_op_speckle_noise(x, params, key_stream[4]))
    outs.append(_op_line_streak(x, params))
    blur_out = _op_blur(x, params)
    outs.append(blur_out)     # gaussian_blur
    outs.append(blur_out)     # defocus_blur (same conv, per-sample kernel)
    outs.append(blur_out)     # motion_blur
    assert len(outs) == len(MEGA_NAMES)

    acc = x
    for i, candidate in enumerate(outs):
        gate = (sel == i)[:, None, None, None]
        acc = jnp.where(gate, candidate, acc)
    return jnp.clip(jnp.round(acc), 0, 255).astype(jnp.uint8)


@jax.jit
def apply_mega_round(images, sel, params, seed):
    """One photometric round over a uint8 batch; returns uint8.

    ``seed``: uint32 scalar — the rng key derives INSIDE the program (an
    eager fold_in chain would cost one dispatch per link)."""
    return _mega_round_core(images, sel, params, seed)


@jax.jit
def apply_mega_round_sub(images, idx, scatter_idx, sel, params, seed):
    """Sparse round: gather the member sub-batch ``idx``, run the round
    there, scatter back.  Every op in the round computes over the
    sub-batch only — rounds touching few samples (typically the second
    policy draw) no longer pay the full-batch cost.

    ``scatter_idx``: ``idx`` with pad slots pointing out of bounds —
    dropped on scatter (pad slots hold rng-bearing duplicates whose
    values must not race the real slot)."""
    sub = jnp.take(images, idx, axis=0)
    res = _mega_round_core(sub, sel, params, seed)
    return images.at[scatter_idx].set(res, mode='drop')
