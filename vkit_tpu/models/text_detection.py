"""Flagship model: text-detection net consuming the pipeline's labels.

The reference is a data-synthesis toolkit with no bundled model; its
pipeline emits char masks, char-height score maps, gaussian centroid score
maps and regression labels (vkit/pipeline/text_detection/
page_text_region_label.py) for a downstream "adaptive scaling" detector.
This module supplies that consumer: a conv-FPN in flax with bfloat16
compute, static shapes, and three dense f32 heads aligned with the
pipeline's downsampled labels (stride 2).
"""
from typing import Sequence, Tuple

import flax.linen as nn
import jax.numpy as jnp
from jax import lax

# The f32 heads are 1x1 convs with one output channel: full f32 costs
# nothing there and keeps their outputs off TF32 rounding.
_HEAD_PRECISION = lax.Precision.HIGHEST


class ConvBlock(nn.Module):
    features: int
    stride: int = 1
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, x):
        x = nn.Conv(
            self.features, (3, 3), strides=(self.stride, self.stride),
            use_bias=False, dtype=self.dtype,
        )(x)
        x = nn.GroupNorm(num_groups=32, dtype=self.dtype)(x)
        x = nn.gelu(x)
        x = nn.Conv(self.features, (3, 3), use_bias=False, dtype=self.dtype)(x)
        x = nn.GroupNorm(num_groups=32, dtype=self.dtype)(x)
        return nn.gelu(x)


class TextDetectionNet(nn.Module):
    """Conv-FPN with char-mask / char-height / gaussian-centroid heads.

    Input: (N, H, W, 3) uint8 (H, W multiples of 16).
    Outputs at stride 2 (matching downsample_labeling_factor=2 in
    page_cropping / page_text_region_cropping):
      - char_mask_logits        (N, H/2, W/2, 1)
      - char_height_raw         (N, H/2, W/2, 1)  (softplus -> pixels)
      - char_gaussian_logits    (N, H/2, W/2, 1)
    """
    stage_features: Sequence[int] = (64, 128, 256, 512)
    fpn_features: int = 128
    dtype: jnp.dtype = jnp.bfloat16

    @nn.compact
    def __call__(self, images) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
        x = images.astype(jnp.float32) / 127.5 - 1.0
        x = x.astype(self.dtype)

        feats = []
        for features in self.stage_features:
            x = ConvBlock(features, stride=2, dtype=self.dtype)(x)
            feats.append(x)

        # Top-down FPN back to stride 2.
        y = nn.Conv(self.fpn_features, (1, 1), dtype=self.dtype)(feats[-1])
        for skip in reversed(feats[:-1]):
            n, h, w, _ = skip.shape
            y = jnp.repeat(jnp.repeat(y, 2, axis=1), 2, axis=2)
            lateral = nn.Conv(self.fpn_features, (1, 1), dtype=self.dtype)(skip)
            y = nn.gelu(
                nn.Conv(self.fpn_features, (3, 3), dtype=self.dtype)(y + lateral)
            )

        y = y.astype(jnp.float32)
        char_mask_logits = nn.Conv(
            1, (1, 1), dtype=jnp.float32, precision=_HEAD_PRECISION
        )(y)
        char_height_raw = nn.Conv(
            1, (1, 1), dtype=jnp.float32, precision=_HEAD_PRECISION
        )(y)
        char_gaussian_logits = nn.Conv(
            1, (1, 1), dtype=jnp.float32, precision=_HEAD_PRECISION
        )(y)
        return char_mask_logits, char_height_raw, char_gaussian_logits
