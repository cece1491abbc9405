"""Quantify the banded-path LSB tail on PRODUCTION policy draws.

VERDICT r4 weak #6: the default banded dense-warp path is bounded at
<= 24 LSB worst-case per pixel (mean <= 1), but nothing measured how often
the tail actually fires on production draws.  This tool samples N
geometric policy draws (the same sampler the synth pipeline uses), warps a
smooth test image through BOTH paths — the default banded coarse-node
program (mode='auto') and the <= 2 LSB reference gather program
(mode='gather') — and reports the fraction of covered pixels whose
difference exceeds 2 / 8 / 16 LSB.  Results go into PARITY.md.

Usage: JAX_PLATFORMS=cpu python tools/measure_warp_tail.py [n_batches]
"""
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402

if __name__ == '__main__' and '--device' not in sys.argv:
    jax.config.update('jax_platforms', 'cpu')

import jax.numpy as jnp  # noqa: E402


def main(n_batches: int = 4, batch: int = 16, side: int = 640):
    from scipy.ndimage import gaussian_filter

    from vkit_tpu.mechanism.batched import batched_plan_warp
    from vkit_tpu.mechanism.batched_random import sample_geometric_plans
    from vkit_tpu.mechanism.distortion.warp_plan import (
        rescale_plan_to,
        warp_active_mask,
    )

    rng = np.random.default_rng(20250819)
    img = gaussian_filter(
        rng.random((side, side, 3)) * 255, sigma=1.5
    ).astype(np.float32)
    out_shape = (704, 704)
    images = jnp.asarray(np.broadcast_to(img, (batch,) + img.shape).copy())

    total = np.zeros(4, dtype=np.int64)   # covered, >2, >8, >16
    max_seen = 0.0
    mean_acc, mean_n = 0.0, 0
    plans_seen = 0
    for _ in range(n_batches):
        raw = sample_geometric_plans(batch, (side, side), 5, rng)
        plans = [rescale_plan_to(p, out_shape) for p in raw]
        auto = np.asarray(
            batched_plan_warp(plans, images, mode='auto')[0]
        )
        gather = np.asarray(
            batched_plan_warp(plans, images, mode='gather')[0]
        )
        for i, plan in enumerate(plans):
            cov = warp_active_mask(plan).mat.astype(bool)
            # Interior only: the contract gates by coverage and both
            # paths extend fields differently outside it.
            from scipy.ndimage import binary_erosion
            core = binary_erosion(cov, iterations=3)
            if not core.any():
                continue
            d = np.abs(auto[i] - gather[i]).max(axis=-1)[core]
            total[0] += d.size
            total[1] += int((d > 2).sum())
            total[2] += int((d > 8).sum())
            total[3] += int((d > 16).sum())
            max_seen = max(max_seen, float(d.max()))
            mean_acc += float(d.sum())
            mean_n += d.size
            plans_seen += 1

    print(f'plans: {plans_seen} production draws @640^2 -> 704^2 letterbox')
    print(f'covered interior pixels: {total[0]:,}')
    for k, label in ((1, '> 2 LSB'), (2, '> 8 LSB'), (3, '> 16 LSB')):
        frac = total[k] / max(total[0], 1)
        print(f'{label}: {total[k]:,} ({frac:.2e})')
    print(f'max: {max_seen:.1f} LSB   mean: {mean_acc / max(mean_n, 1):.4f} LSB')


if __name__ == '__main__':
    n = int(sys.argv[1]) if len(sys.argv) > 1 and sys.argv[1].isdigit() else 4
    main(n)
