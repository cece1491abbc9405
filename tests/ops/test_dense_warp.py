"""Dense displacement-field two-pass warp + batched grid-distortion bridge."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vkit_tpu.ops.warp import remap_np
from vkit_tpu.ops.warp_mxu import warp_dense_batch_mxu


@pytest.fixture(scope='module')
def smooth_image():
    from scipy.ndimage import gaussian_filter

    rng = np.random.default_rng(0)
    return gaussian_filter(
        rng.random((96, 96, 3)) * 255, sigma=2
    ).astype(np.float32)


def test_separable_fields_exact(smooth_image):
    h, w = smooth_image.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    fields = [
        (ys, xs),
        (ys + 7.0 * np.sin(2 * np.pi * xs / w), xs),
        (ys, xs + 4.0 * np.sin(2 * np.pi * ys / h)),
    ]
    map_ys = np.stack([f[0] for f in fields])
    map_xs = np.stack([f[1] for f in fields])
    imgs = jnp.asarray(np.stack([smooth_image] * len(fields)))
    out = np.asarray(warp_dense_batch_mxu(imgs, map_ys, map_xs))
    for i, (my, mx) in enumerate(fields):
        ref = remap_np(
            smooth_image, my.astype(np.float32), mx.astype(np.float32)
        )
        assert np.abs(out[i] - ref).max() < 1e-3


def test_mixed_field_close(smooth_image):
    h, w = smooth_image.shape[:2]
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    my = ys + 6.0 * np.sin(2 * np.pi * xs / w)
    mx = xs + 4.0 * np.sin(2 * np.pi * ys / h)
    imgs = jnp.asarray(smooth_image[None])
    out = np.asarray(warp_dense_batch_mxu(imgs, my[None], mx[None]))[0]
    ref = remap_np(smooth_image, my.astype(np.float32), mx.astype(np.float32))
    interior = (my > 2) & (my < h - 3) & (mx > 2) & (mx < w - 3)
    assert np.abs(out - ref)[interior].max() < 1.0


def test_banded_plan_rejects_oversized_sources():
    """Sources longer than the kernel window's base capacity (1280 px)
    must REJECT to the gather fallback, not silently clamp bases (which
    zeroes far-edge content — advisor finding r3)."""
    from vkit_tpu.ops.warp_banded import plan_banded_warp

    def identity_plan(size):
        nodes = np.unique(
            np.concatenate([np.arange(0, size, 64), [size - 1]])
        ).astype(np.float64)
        r = q = len(nodes)
        cy = np.broadcast_to(nodes[:, None], (r, q))[None].copy()
        cx = np.broadcast_to(nodes[None, :], (r, q))[None].copy()
        return plan_banded_warp(
            cy, cx, nodes, nodes, (size, size), (size, size)
        )

    # Control: a normal canvas plans with no rejects.
    planned = identity_plan(640)
    assert planned is not None and len(planned[2]) == 0
    # 1400 px: bases land at 128-block starts, the largest (1278) still
    # fits the window — servable, must NOT reject.
    planned = identity_plan(1400)
    assert planned is not None and len(planned[2]) == 0
    # 1600 px: far-edge blocks need bases ~1534 > 1280; the single
    # sample must reject (plan returns None when all samples reject).
    assert identity_plan(1600) is None


def test_batched_grid_warp_camera():
    from scipy.ndimage import binary_erosion, gaussian_filter

    from vkit_tpu.element import Image
    from vkit_tpu.mechanism.batched import batched_grid_warp
    from vkit_tpu.mechanism.distortion import (
        CameraCubicCurveConfig,
        CameraModelConfig,
        camera_cubic_curve,
    )

    rng = np.random.default_rng(0)
    h = w = 96
    img = gaussian_filter(rng.random((h, w, 3)) * 255, sigma=2).astype(np.uint8)

    def cam(theta, alpha, beta):
        return CameraCubicCurveConfig(
            curve_alpha=alpha, curve_beta=beta,
            curve_direction=0.0, curve_scale=1.0,
            camera_model_config=CameraModelConfig(
                rotation_unit_vec=[1.0, 0.0, 0.0], rotation_theta=theta,
            ),
            grid_size=10,
        )

    # All fields ride the banded device path (ops/warp_banded.py), whose
    # positions come from coarse-node bilinear interpolation — subpixel
    # approximate (~0.5px) rather than per-cell exact.  The bound is a
    # tight mean + loose max against the exact per-element host result.
    for configs in [
        [cam(2, -4, -4), cam(3, 3, 5)],
        [cam(10, -20, -20), cam(15, 15, 25)],
    ]:
        imgs = jnp.asarray(np.stack([img] * len(configs)))
        warped, shapes, covs = batched_grid_warp(
            camera_cubic_curve, configs, imgs, rng=np.random.default_rng(1)
        )
        warped = np.asarray(warped)
        for i, cfg in enumerate(configs):
            ref = camera_cubic_curve.distort_image(
                cfg, Image(mat=img), rng=np.random.default_rng(1)
            )
            hh, ww = shapes[i]
            assert ref.shape == (hh, ww)
            core = binary_erosion(covs[i], iterations=4)
            diff = np.abs(
                warped[i, :hh, :ww].astype(int) - ref.mat.astype(int)
            )
            assert diff[core].mean() <= 1.0, diff[core].mean()
            assert diff[core].max() <= 24, diff[core].max()


def test_batched_grid_warp_mls():
    from scipy.ndimage import binary_erosion, gaussian_filter

    from vkit_tpu.element import Image, Point, PointTuple
    from vkit_tpu.mechanism.batched import batched_grid_warp
    from vkit_tpu.mechanism.distortion import (
        SimilarityMlsConfig,
        similarity_mls,
    )

    rng = np.random.default_rng(0)
    h = w = 96
    img = gaussian_filter(rng.random((h, w, 3)) * 255, sigma=2).astype(np.uint8)

    def mls(dy, dx):
        src = PointTuple([
            Point.create(y=0, x=0), Point.create(y=0, x=w - 1),
            Point.create(y=h - 1, x=w - 1), Point.create(y=h - 1, x=0),
            Point.create(y=h // 2, x=w // 2),
        ])
        dst = PointTuple([
            Point.create(y=0, x=0), Point.create(y=0, x=w - 1),
            Point.create(y=h - 1, x=w - 1), Point.create(y=h - 1, x=0),
            Point.create(y=h // 2 + dy, x=w // 2 + dx),
        ])
        return SimilarityMlsConfig(
            src_handle_points=src, dst_handle_points=dst, grid_size=12,
        )

    configs = [mls(5, 3), mls(-4, 6)]
    imgs = jnp.asarray(np.stack([img] * len(configs)))
    warped, shapes, covs = batched_grid_warp(
        similarity_mls, configs, imgs, rng=np.random.default_rng(1)
    )
    warped = np.asarray(warped)
    for i, cfg in enumerate(configs):
        ref = similarity_mls.distort_image(
            cfg, Image(mat=img), rng=np.random.default_rng(1)
        )
        hh, ww = shapes[i]
        assert ref.shape == (hh, ww)
        core = binary_erosion(covs[i], iterations=4)
        diff = np.abs(warped[i, :hh, :ww].astype(int) - ref.mat.astype(int))
        # Banded device path: coarse-node positions are subpixel
        # approximate (see the camera test above).
        assert diff[core].mean() <= 1.0, diff[core].mean()
        assert diff[core].max() <= 24, diff[core].max()


def test_coarse_nodes_16px_fidelity():
    """The documented dense-warp fidelity bar (max <= 24 LSB, mean <= 1)
    enforced AT THE PRODUCTION NODE SPACING: a >= 320 px canvas routes
    _build_coarse_nodes through COARSE_NODE_STEP = 16 (batched.py), and
    this test pins the bound to that constant — advisor r4: the 8-px
    small-canvas tests left the 16-px bar unenforced."""
    from scipy.ndimage import binary_erosion, gaussian_filter

    from vkit_tpu.element import Image
    from vkit_tpu.mechanism import batched
    from vkit_tpu.mechanism.batched import batched_grid_warp
    from vkit_tpu.mechanism.distortion import (
        CameraCubicCurveConfig,
        CameraModelConfig,
        camera_cubic_curve,
    )

    rng = np.random.default_rng(0)
    h = w = 384
    assert min(h, w) >= batched._FINE_NODE_CANVAS, (
        'canvas no longer exercises the coarse 16-px node grid; '
        'update the test alongside _FINE_NODE_CANVAS'
    )
    assert batched.COARSE_NODE_STEP == 16, (
        'node spacing changed: re-verify the <= 24 LSB / mean <= 1 bar '
        'at the new spacing and update PARITY.md'
    )
    img = gaussian_filter(rng.random((h, w, 3)) * 255, sigma=2).astype(np.uint8)

    configs = [
        CameraCubicCurveConfig(
            curve_alpha=-18, curve_beta=-18,
            curve_direction=0.0, curve_scale=1.0,
            camera_model_config=CameraModelConfig(
                rotation_unit_vec=[1.0, 0.0, 0.0], rotation_theta=12,
            ),
            grid_size=10,
        ),
        CameraCubicCurveConfig(
            curve_alpha=12, curve_beta=20,
            curve_direction=30.0, curve_scale=1.0,
            camera_model_config=CameraModelConfig(
                rotation_unit_vec=[0.0, 1.0, 0.0], rotation_theta=8,
            ),
            grid_size=10,
        ),
    ]
    imgs = jnp.asarray(np.stack([img] * len(configs)))
    warped, shapes, covs = batched_grid_warp(
        camera_cubic_curve, configs, imgs, rng=np.random.default_rng(1)
    )
    warped = np.asarray(warped)
    for i, cfg in enumerate(configs):
        ref = camera_cubic_curve.distort_image(
            cfg, Image(mat=img), rng=np.random.default_rng(1)
        )
        hh, ww = shapes[i]
        assert ref.shape == (hh, ww)
        diff = np.abs(
            warped[i, :hh, :ww].astype(int) - ref.mat.astype(int)
        )
        # Interior = one node cell in from the coverage edge: the <= 24
        # LSB / mean <= 1 bar holds there.  The EDGE BAND (within one
        # 16-px cell of the coverage boundary) is approximated by the
        # node field's linear extension and can reach ~140 LSB on strong
        # camera curves at < 1e-3 pixel frequency — measured and
        # documented in PARITY.md (tools/measure_warp_tail.py).
        near = binary_erosion(covs[i], iterations=4)
        core = binary_erosion(covs[i], iterations=batched.COARSE_NODE_STEP)
        assert diff[near].mean() <= 1.0, diff[near].mean()
        assert diff[core].max() <= 24, diff[core].max()
        frac_big = (diff[near].max(axis=-1) > 24).mean()
        assert frac_big <= 1e-3, frac_big
