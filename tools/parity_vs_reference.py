"""Pixel parity: vkit_tpu distortion catalog vs the ACTUAL reference.

Runs each deterministic distortion with a fixed config on the same input
through both implementations and reports pixel MAE (plus result-shape
agreement for the geometric ops).  rng-consuming ops (noise, glass blur,
fog, channel permutation) are excluded: the two rng disciplines differ by
design (distributional, not bitwise, equivalence).

Usage: python tools/parity_vs_reference.py
"""
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / 'tools' / 'refshims'))
sys.path.insert(0, '/root/reference')
sys.path.insert(0, str(REPO))

import os
os.environ.setdefault('DISABLE_VKIT_COLLECT_USAGE_INFORMATION', '1')

import numpy as np  # noqa: E402

# cv2 >= 5 rejects read-only draw targets (the reference draws into frozen
# Mask mats); shim a writable copy.
import cv2  # noqa: E402

_orig_cv_ellipse = cv2.ellipse


def _ellipse_compat(img, *args, **kwargs):
    if isinstance(img, np.ndarray) and not img.flags.writeable:
        img = img.copy()
    return _orig_cv_ellipse(img, *args, **kwargs)


cv2.ellipse = _ellipse_compat

CASES = [
    # (name, config, is_geometric)
    ('mean_shift', {'delta': 37}, False),
    ('color_shift', {'delta': 40}, False),
    ('brightness_shift', {'delta': -25}, False),
    ('std_shift', {'scale': 1.4}, False),
    ('boundary_equalization', {}, False),
    ('histogram_equalization', {}, False),
    ('complement', {}, False),
    ('posterization', {'num_bits': 3}, False),
    ('color_balance', {'ratio': 0.35}, False),
    ('gaussian_blur', {'sigma': 1.4}, False),
    ('defocus_blur', {'radius': 2}, False),
    ('motion_blur', {'radius': 3, 'angle': 37}, False),
    ('jpeg_quality', {'quality': 35}, False),
    ('pixelation', {'ratio': 0.5}, False),
    ('line_streak', {'thickness': 2, 'gap': 11, 'alpha': 0.6}, False),
    ('rectangle_streak', {'thickness': 2, 'short_side_min': 12}, False),
    ('ellipse_streak', {'thickness': 2, 'short_side_min': 12}, False),
    ('shear_hori', {'angle': 14}, True),
    ('shear_vert', {'angle': -11}, True),
    ('rotate', {'angle': 33}, True),
    ('skew_hori', {'ratio': 0.2}, True),
    ('skew_vert', {'ratio': -0.15}, True),
    ('similarity_mls', None, True),   # Built below (needs point types).
    ('camera_cubic_curve', {
        'curve_alpha': 15, 'curve_beta': -12, 'curve_direction': 30,
        'curve_scale': 1.0,
        'camera_model_config': {
            'rotation_unit_vec': [1.0, 0.0, 0.0], 'rotation_theta': 8,
        },
        'grid_size': 20,
    }, True),
    ('camera_plane_only', {
        'camera_model_config': {
            'rotation_unit_vec': [0.4, 0.6, 0.0], 'rotation_theta': 10,
        },
        'grid_size': 20,
    }, True),
    ('camera_plane_line_fold', {
        'fold_point': (100, 80), 'fold_direction': 40,
        'fold_perturb_vec': (0.0, 0.0, 40.0), 'fold_alpha': 0.5,
        'camera_model_config': {
            'rotation_unit_vec': [0.8, 0.2, 0.0], 'rotation_theta': 6,
        },
        'grid_size': 20,
    }, True),
    ('camera_plane_line_curve', {
        'curve_point': (100, 80), 'curve_direction': 110,
        'curve_perturb_vec': (0.0, 0.0, 40.0), 'curve_alpha': 1.5,
        'camera_model_config': {
            'rotation_unit_vec': [0.2, 0.8, 0.0], 'rotation_theta': 6,
        },
        'grid_size': 20,
    }, True),
]


def mls_config(module):
    PointTuple = module.PointTuple
    src = PointTuple.from_xy_pairs(
        [(0, 0), (199, 0), (199, 159), (0, 159), (100, 80)]
    )
    dst = PointTuple.from_xy_pairs(
        [(0, 0), (199, 0), (199, 159), (0, 159), (112, 92)]
    )
    return {
        'src_handle_points': src, 'dst_handle_points': dst, 'grid_size': 20,
    }


def main():
    import cv2  # noqa: F401 - ensures the compat question is visible early.

    import vkit.element as ref_element
    import vkit.mechanism.distortion as ref_distortion

    import vkit_tpu.element as our_element
    import vkit_tpu.mechanism.distortion as our_distortion

    rng = np.random.default_rng(7)
    mat = rng.integers(0, 256, (160, 200, 3), dtype=np.uint8)

    rows = []
    worst = 0.0
    for name, config, is_geometric in CASES:
        ref_cfg = config if config is not None else mls_config(ref_element)
        our_cfg = config if config is not None else mls_config(our_element)

        ref_img = getattr(ref_distortion, name).distort_image(
            ref_cfg, ref_element.Image(mat=mat.copy()),
            rng=np.random.default_rng(3),
        )
        our_img = getattr(our_distortion, name).distort_image(
            our_cfg, our_element.Image(mat=mat.copy()),
            rng=np.random.default_rng(3),
        )

        if ref_img.shape != our_img.shape:
            h = min(ref_img.height, our_img.height)
            w = min(ref_img.width, our_img.width)
            dh = abs(ref_img.height - our_img.height)
            dw = abs(ref_img.width - our_img.width)
            assert dh <= 2 and dw <= 2, (
                f'{name}: shapes diverge {ref_img.shape} vs {our_img.shape}'
            )
            a = ref_img.mat[:h, :w]
            b = our_img.mat[:h, :w]
            shape_note = f'{ref_img.shape}~{our_img.shape}'
        else:
            a, b = ref_img.mat, our_img.mat
            shape_note = str(our_img.shape)

        if is_geometric:
            # Compare interiors: border taps + grid-edge coverage differ.
            inner = (slice(8, -8), slice(8, -8))
            a, b = a[inner], b[inner]
        mae = float(np.abs(a.astype(np.float32) - b.astype(np.float32)).mean())
        worst = max(worst, mae)
        rows.append((name, shape_note, mae))
        print(f'{name:28s} {shape_note:24s} MAE={mae:8.4f}')

    print(f'\nworst MAE: {worst:.4f} over {len(rows)} deterministic ops')
    return rows


if __name__ == '__main__':
    main()
