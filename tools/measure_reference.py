"""Measure the ACTUAL reference (vkit @ /root/reference) on this host.

The reference's engine/pipeline layers need external assets (fonts, image
datasets, corpora) that this environment does not ship, so the end-to-end
17-step pipeline cannot run here.  What CAN run — via the pure-Python shims
in tools/refshims (shapely/pyclipper/cattrs/iolite/intervaltree, backed by
vkit_tpu.geometry) — is the north-star workload itself: the full
RandomDistortion pipeline (policy sampling + photometric + geometric +
trim) co-transforming a 640x640 page image, active mask, score map, and
polygon/point labels.

Usage:
    python tools/measure_reference.py [--num-seeds 16] [--side 640]

Writes BASELINE_REF.json and prints a summary.
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent

sys.path.insert(0, str(REPO / 'tools' / 'refshims'))
sys.path.insert(0, '/root/reference')
sys.path.insert(0, str(REPO))

import os
os.environ.setdefault('DISABLE_VKIT_COLLECT_USAGE_INFORMATION', '1')

import numpy as np  # noqa: E402

# cv2 >= 5 rejects read-only arrays as draw targets; the pinned-era cv2 the
# reference was built against tolerated them (it draws into frozen Mask
# mats and re-assigns the returned array).  Shim a writable copy.
import cv2  # noqa: E402

_orig_cv_ellipse = cv2.ellipse


def _ellipse_compat(img, *args, **kwargs):
    if isinstance(img, np.ndarray) and not img.flags.writeable:
        img = img.copy()
    return _orig_cv_ellipse(img, *args, **kwargs)


cv2.ellipse = _ellipse_compat


def build_sample(side: int, rng):
    """Synthetic page + labels shaped like the text-detection pipeline's."""
    from vkit.element import Image, Mask, Point, PointList, Polygon, ScoreMap

    image = Image(mat=rng.integers(0, 256, (side, side, 3), dtype=np.uint8))
    mask = Mask.from_shape((side, side), value=1)

    score_map = ScoreMap(
        mat=rng.random((side, side), dtype=np.float64).astype(np.float32)
    )

    polygons = []
    points = PointList()
    cell = side // 8
    for row in range(8):
        for col in range(8):
            up = row * cell + 4
            left = col * cell + 4
            polygons.append(Polygon.from_xy_pairs([
                (left, up), (left + cell - 8, up),
                (left + cell - 8, up + cell // 2), (left, up + cell // 2),
            ]))
            points.append(Point.create(y=up, x=left))
    return image, mask, score_map, polygons, points


def measure_reference_random_distortion(num_seeds: int, side: int):
    from vkit.mechanism.distortion_policy.random_distortion import (
        random_distortion_factory,
    )

    random_distortion = random_distortion_factory.create({
        # Same default the device pipeline uses.
        'disabled_policy_names': ['defocus_blur', 'zoom_in_blur'],
    })

    # Warm up caches / imports with one run.
    rng = np.random.default_rng(0)
    sample = build_sample(side, rng)
    random_distortion.distort(
        rng=rng, image=sample[0], mask=sample[1], score_map=sample[2],
        polygons=sample[3], points=sample[4],
    )

    begin = time.perf_counter()
    for seed in range(1, num_seeds + 1):
        rng = np.random.default_rng(seed)
        image, mask, score_map, polygons, points = build_sample(side, rng)
        result = random_distortion.distort(
            rng=rng, image=image, mask=mask, score_map=score_map,
            polygons=polygons, points=points,
        )
        assert result.image is not None
    elapsed = time.perf_counter() - begin
    return num_seeds / elapsed, elapsed


def measure_reference_fixed_chain(num_iters: int, side: int):
    """The reference running the bench.py fixed chain (config 1+2 proxy):
    affine warp + contrast + brightness + gaussian noise + jpeg + resize."""
    import cv2

    from vkit.element import Image
    from vkit.mechanism import distortion as ref_distortion

    rng = np.random.default_rng(0)
    mat = rng.integers(0, 256, (side, side, 3), dtype=np.uint8)

    def one(mat):
        image = Image(mat=mat)
        image = ref_distortion.rotate.distort_image({'angle': 17}, image)
        image = ref_distortion.std_shift.distort_image({'scale': 1.2}, image)
        image = ref_distortion.brightness_shift.distort_image(
            {'delta': 20}, image
        )
        image = ref_distortion.gaussion_noise.distort_image(
            {'std': 8}, image, rng=np.random.default_rng(1)
        )
        image = ref_distortion.jpeg_quality.distort_image({'quality': 40}, image)
        resized = cv2.resize(image.mat, (side, side), interpolation=cv2.INTER_AREA)
        return resized

    one(mat)  # Warm up.
    begin = time.perf_counter()
    for _ in range(num_iters):
        out = one(mat)
    elapsed = time.perf_counter() - begin
    assert out is not None
    return num_iters / elapsed, elapsed


def measure_reference_single_distortion(name: str, config: dict,
                                        num_iters: int, side: int,
                                        with_labels: bool = True):
    """One catalog distortion with full label co-transform (the per-config
    baseline for BENCH configs 2-4)."""
    from vkit.mechanism import distortion as ref_distortion

    dist = getattr(ref_distortion, name)
    rng = np.random.default_rng(0)
    image, mask, score_map, polygons, points = build_sample(side, rng)

    def one(seed):
        kwargs = {'image': image}
        if with_labels:
            kwargs.update(mask=mask, score_map=score_map,
                          polygons=polygons, points=points)
        return dist.distort(
            config, rng=np.random.default_rng(seed), **kwargs
        )

    one(0)
    begin = time.perf_counter()
    for seed in range(1, num_iters + 1):
        result = one(seed)
    elapsed = time.perf_counter() - begin
    assert result.image is not None
    return num_iters / elapsed, elapsed


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--num-seeds', type=int, default=16)
    parser.add_argument('--side', type=int, default=640)
    args = parser.parse_args()

    import multiprocessing
    print(f'host cores: {multiprocessing.cpu_count()}')

    chain_rate, chain_secs = measure_reference_fixed_chain(
        max(4, args.num_seeds // 2), args.side
    )
    print(f'reference fixed distortion chain @{args.side}: '
          f'{chain_rate:.2f} samples/sec ({chain_secs:.1f}s)')

    rd_rate, rd_secs = measure_reference_random_distortion(
        args.num_seeds, args.side
    )
    print(f'reference RandomDistortion pipeline @{args.side}: '
          f'{rd_rate:.2f} samples/sec ({rd_secs:.1f}s, {args.num_seeds} seeds)')

    iters = max(4, args.num_seeds // 2)
    affine_rate, _ = measure_reference_single_distortion(
        'rotate', {'angle': 17}, iters, args.side
    )
    print(f'reference rotate + label co-transform @{args.side}: '
          f'{affine_rate:.2f} samples/sec')
    camera_rate, _ = measure_reference_single_distortion(
        'camera_cubic_curve',
        {
            'curve_alpha': 12, 'curve_beta': -10, 'curve_direction': 0,
            'curve_scale': 1.0,
            'camera_model_config': {
                'rotation_unit_vec': [1.0, 0.0, 0.0], 'rotation_theta': 6,
            },
            'grid_size': 16,
        },
        iters, args.side,
    )
    print(f'reference camera_cubic_curve + labels @{args.side}: '
          f'{camera_rate:.2f} samples/sec')
    from vkit.element import Point

    mls_rate, _ = measure_reference_single_distortion(
        'similarity_mls',
        {
            'src_handle_points': [
                Point.create(y=100, x=100),
                Point.create(y=100, x=args.side - 100),
                Point.create(y=args.side - 100, x=100),
                Point.create(y=args.side - 100, x=args.side - 100),
            ],
            'dst_handle_points': [
                Point.create(y=120, x=90),
                Point.create(y=80, x=args.side - 80),
                Point.create(y=args.side - 110, x=130),
                Point.create(y=args.side - 90, x=args.side - 120),
            ],
            'grid_size': 16,
        },
        iters, args.side,
    )
    print(f'reference similarity_mls + labels @{args.side}: '
          f'{mls_rate:.2f} samples/sec')

    payload = {
        'host_cores': multiprocessing.cpu_count(),
        'side': args.side,
        'reference_fixed_chain_samples_per_sec': round(chain_rate, 4),
        'reference_random_distortion_samples_per_sec': round(rd_rate, 4),
        'reference_rotate_with_labels_samples_per_sec': round(affine_rate, 4),
        'reference_camera_cubic_curve_samples_per_sec': round(camera_rate, 4),
        'reference_similarity_mls_samples_per_sec': round(mls_rate, 4),
        'num_seeds': args.num_seeds,
        'notes': (
            'Measured on /root/reference via tools/refshims '
            '(shapely/pyclipper/cattrs/iolite/intervaltree shims backed by '
            'vkit_tpu.geometry). The 17-step pipeline needs font/image/'
            'corpus assets absent from this environment; the RandomDistortion '
            'number IS the north-star "full distortion pipeline" workload '
            '(policy sampling + photometric + geometric + label co-transform '
            '+ trim) on one host core.'
        ),
    }
    (REPO / 'BASELINE_REF.json').write_text(json.dumps(payload, indent=2))
    print('wrote BASELINE_REF.json')


if __name__ == '__main__':
    main()
