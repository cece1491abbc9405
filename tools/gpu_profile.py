"""Device times of the line primitives and of the warp routes on a GPU.

    python tools/gpu_profile.py

1. Line primitives at the bench widths (640^2 pages, batch 32, C = 3 and
   7): ``row_shift`` at the planner's canonical shift width and
   ``banded_line_resample`` at the 704-canvas band.  Each runs alone in a
   profiler trace; its device time is the union of the kernel intervals
   on the GPU plane, and its rate is the bytes it must move (input once,
   output once) over that time, beside the 3.35 TB/s HBM peak of an H100
   SXM (NVIDIA data sheet) and a plain copy measured in the same run.
2. ``batched_plan_warp`` with ``mode='auto'`` against ``mode='gather'``
   for the bench workloads (fixed chain, affine + labels, camera + labels,
   MLS + labels, RandomDistortion + labels): median host-clock seconds per
   batch over 5 calls after 2 warm-up calls, ending in block_until_ready,
   host planning included.

Prints one line per measurement and, last, a JSON summary; refuses to run
without a GPU.
"""
import argparse
import glob
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

HBM_PEAK_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet


def device_busy_ns(trace_dir: str) -> float:
    """Union of kernel intervals on the GPU planes of one trace."""
    from jax.profiler import ProfileData

    paths = glob.glob(f'{trace_dir}/**/*.xplane.pb', recursive=True)
    if len(paths) != 1:
        raise RuntimeError(f'expected one trace file, found {paths}')
    intervals = []
    for plane in ProfileData.from_file(paths[0]).planes:
        if not plane.name.startswith('/device:GPU'):
            continue
        for line in plane.lines:
            # Stream lines carry the kernels; derived lines (XLA Modules /
            # Ops, Steps) repeat them and are skipped.
            if not line.name.startswith('Stream'):
                continue
            for ev in line.events:
                intervals.append((ev.start_ns, ev.start_ns + ev.duration_ns))
    if not intervals:
        raise RuntimeError('no GPU kernel events in the trace')
    intervals.sort()
    busy, cur_lo, cur_hi = 0.0, *intervals[0]
    for lo, hi in intervals[1:]:
        if lo > cur_hi:
            busy += cur_hi - cur_lo
            cur_lo, cur_hi = lo, hi
        else:
            cur_hi = max(cur_hi, hi)
    return busy + cur_hi - cur_lo


def traced_device_seconds(fn, args, iters=10):
    """Device seconds per call of a jitted ``fn`` (compiled beforehand)."""
    import jax

    jax.block_until_ready(fn(*args))
    with tempfile.TemporaryDirectory() as tmp:
        jax.profiler.start_trace(tmp)
        for _ in range(iters):
            out = fn(*args)
        jax.block_until_ready(out)
        jax.profiler.stop_trace()
        return device_busy_ns(tmp) / iters * 1e-9


def primitive_rows(batch=32, side=640, canvas=704):
    import jax
    import jax.numpy as jnp

    from vkit_tpu.ops.warp_banded import banded_line_resample
    from vkit_tpu.ops.warp_mxu import plan_affine_warp, row_shift
    from vkit_tpu.parallel import sample_synthesis_params

    rng = np.random.default_rng(0)
    params, _ = sample_synthesis_params(rng, batch, side, side, level=5)
    mats = np.asarray(params.trans_mats, dtype=np.float64)
    _, statics = plan_affine_warp(mats, (side, side), (canvas, canvas),
                                  canonical=True)
    m_shift = statics.statics_v.m_shift
    jp = -(-canvas // 128) * 128
    rows = []

    big = jnp.ones((1 << 28,), jnp.float32)            # 1 GiB
    copy_s = traced_device_seconds(jax.jit(lambda a: a * 1.0 + 0.0), (big,))
    copy_rate = 2 * big.nbytes / copy_s
    rows.append({'name': 'plain copy 1 GiB f32', 'device_ms': copy_s * 1e3,
                 'gbytes_per_s': copy_rate / 1e9,
                 'hbm_share': copy_rate / HBM_PEAK_BYTES_PER_S})
    del big

    shift = jax.jit(row_shift, static_argnums=(2,))
    banded = jax.jit(banded_line_resample, static_argnums=(3,))
    for c in (3, 7):
        x = jnp.asarray(rng.random((batch, side, c, side), dtype=np.float32))
        starts = jnp.asarray(
            rng.integers(-256, 256, (batch, side)).astype(np.int32))
        secs = traced_device_seconds(shift, (x, starts, m_shift))
        moved = x.nbytes + batch * side * c * m_shift * 4 + starts.nbytes
        rows.append({'name': f'row_shift C={c} out={m_shift}',
                     'device_ms': secs * 1e3,
                     'gbytes_per_s': moved / secs / 1e9,
                     'hbm_share': moved / secs / HBM_PEAK_BYTES_PER_S})

        base = rng.integers(-8, side - 100, (batch, -(-side // 8), jp // 128))
        b_full = np.repeat(np.repeat(base, 8, axis=1)[:, :side], 128, axis=2)
        pos = (b_full + np.arange(jp) % 128
               + rng.uniform(0, 30, (batch, side, jp))).astype(np.float32)
        args = (x, jnp.asarray(base, jnp.int32), jnp.asarray(pos), 64)
        secs = traced_device_seconds(banded, args)
        moved = x.nbytes + pos.nbytes + batch * side * c * jp * 4
        rows.append({'name': f'banded C={c} J={jp}',
                     'device_ms': secs * 1e3,
                     'gbytes_per_s': moved / secs / 1e9,
                     'hbm_share': moved / secs / HBM_PEAK_BYTES_PER_S})
    return rows


def _workload_plans(name, batch, side, rng):
    from vkit_tpu.element import Point
    from vkit_tpu.mechanism.batched_random import sample_geometric_plans
    from vkit_tpu.mechanism.distortion import (
        camera_cubic_curve,
        rotate,
        similarity_mls,
    )
    from vkit_tpu.mechanism.distortion.warp_plan import (
        matrix_plan,
        rescale_plan_to,
    )
    from vkit_tpu.parallel import sample_synthesis_params

    if name == 'fixed_chain':
        params, _ = sample_synthesis_params(rng, batch, side, side, level=5)
        mats = np.asarray(params.trans_mats, dtype=np.float64)
        return [matrix_plan(m, (side, side), (side, side)) for m in mats], \
            None, 3
    if name == 'affine_labels':
        return [rotate.plan({'angle': 17.0 + 0.01 * i}, (side, side), rng)
                for i in range(batch)], (side * 13 // 10,) * 2, 5
    if name == 'camera_labels':
        cfg = {'curve_alpha': 12, 'curve_beta': -10, 'curve_direction': 0,
               'curve_scale': 1.0, 'grid_size': 16,
               'camera_model_config': {'rotation_unit_vec': [1.0, 0.0, 0.0],
                                       'rotation_theta': 6}}
        return [camera_cubic_curve.plan(cfg, (side, side), rng)
                for _ in range(batch)], (side * 11 // 10,) * 2, 5
    if name == 'mls_labels':
        p = Point.create
        cfg = {'src_handle_points': [p(y=100, x=100), p(y=100, x=side - 100),
                                     p(y=side - 100, x=100),
                                     p(y=side - 100, x=side - 100)],
               'dst_handle_points': [p(y=120, x=90), p(y=80, x=side - 80),
                                     p(y=side - 110, x=130),
                                     p(y=side - 90, x=side - 120)],
               'grid_size': 16}
        return [similarity_mls.plan(cfg, (side, side), rng)
                for _ in range(batch)], (side * 11 // 10,) * 2, 5
    if name == 'random_distortion':
        plans = sample_geometric_plans(batch, (side, side), 5, rng)
        return [rescale_plan_to(p, (side * 11 // 10,) * 2)
                for p in plans], None, 5
    raise ValueError(name)


def route_rows(side=640, batch_div=1):
    import jax
    import jax.numpy as jnp

    from vkit_tpu.mechanism import batched

    rows = []
    for name, batch in (('fixed_chain', 64), ('affine_labels', 64),
                        ('camera_labels', 32), ('mls_labels', 32),
                        ('random_distortion', 32)):
        batch //= batch_div
        rng = np.random.default_rng(1)
        plans, canvas, c = _workload_plans(name, batch, side, rng)
        stack = jnp.asarray(
            rng.integers(0, 256, (batch, side, side, c)).astype(np.float32))
        row = {'name': name, 'batch': batch, 'channels': c}
        for mode in ('auto', 'gather'):
            def call():
                return jax.block_until_ready(batched.batched_plan_warp(
                    plans, stack, canvas_shape=canvas, mode=mode)[0])
            for _ in range(2):
                call()
            routes = dict(batched.LAST_ROUTES)
            times = []
            for _ in range(5):
                t0 = time.perf_counter()
                call()
                times.append(time.perf_counter() - t0)
            row[f'{mode}_ms'] = statistics.median(times) * 1e3
            row[f'{mode}_routes'] = routes
        rows.append(row)
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.parse_args(argv)
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    import jax

    if jax.devices()[0].platform != 'gpu':
        print(f'needs a GPU; found {jax.devices()[0].platform}',
              file=sys.stderr)
        return 2
    print(card, flush=True)
    summary = {'card': card, 'device_kind': jax.devices()[0].device_kind,
               'primitives': primitive_rows(), 'routes': None}
    for row in summary['primitives']:
        print(f"{row['name']}: {row['device_ms']:.3f} ms device, "
              f"{row['gbytes_per_s']:.0f} GB/s = "
              f"{row['hbm_share'] * 100:.1f}% of 3.35 TB/s", flush=True)
    summary['routes'] = route_rows()
    for row in summary['routes']:
        print(f"{row['name']} (batch {row['batch']}, C={row['channels']}): "
              f"auto {row['auto_ms']:.1f} ms {row['auto_routes']} | gather "
              f"{row['gather_ms']:.1f} ms", flush=True)
    print(json.dumps(summary))
    return 0


if __name__ == '__main__':
    sys.exit(main())
