"""Device-side resize: separable tap matrices as two matmuls.

``out = W_rows @ img @ W_cols.T`` — the same weight matrices as the host path
(vkit_tpu/ops/resize_taps.py) applied as two full-f32 matmuls.  Weight construction is host-side numpy (static shapes under
jit, cached per (src, dst, interp)).
"""
import functools
from typing import Tuple

import jax.numpy as jnp
from jax import lax

from .common import expand_chw, round_u8
from .resize_taps import Interpolation, build_resize_weights


@functools.lru_cache(maxsize=4096)
def _weights(n_src: int, n_dst: int, interpolation: Interpolation):
    return build_resize_weights(n_src, n_dst, interpolation)


def resize(
    image,
    resized_shape: Tuple[int, int],
    interpolation: Interpolation = Interpolation.LINEAR,
):
    """Resize (H, W[, C]) or (N, H, W, C) to ``resized_shape``; dtype kept."""
    batched = image.ndim == 4
    if not batched:
        image3, had_c = expand_chw(image)
        image4 = image3[None]
    else:
        image4 = image
        had_c = True

    n, height, width, channels = image4.shape
    dst_h, dst_w = resized_shape
    w_rows = jnp.asarray(_weights(height, dst_h, interpolation))
    w_cols = jnp.asarray(_weights(width, dst_w, interpolation))

    x = image4.astype(jnp.float32)
    # (N, H, W, C) -> rows: contract H.
    x = jnp.einsum('nhwc,vh->nvwc', x, w_rows,
                   precision=lax.Precision.HIGHEST)
    x = jnp.einsum('nvwc,uw->nvuc', x, w_cols,
                   precision=lax.Precision.HIGHEST)

    if image.dtype == jnp.uint8:
        x = round_u8(x)
    else:
        x = x.astype(image.dtype)

    if not batched:
        x = x[0]
        if not had_c:
            x = x[..., 0]
    return x
