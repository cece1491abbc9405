"""Test harness config.

The suite runs on a virtual 8-device CPU mesh: the platform is pinned to
CPU here, before any backend initializes.  Tests that need an NVIDIA GPU
carry the ``gpu`` marker (pytest.ini) and skip without one; run them on a
card with ``VKIT_TEST_GPU=1 python -m pytest -m gpu tests/``, which leaves
the platform to JAX (chip_smoke.py runs them in-process that way).
"""
import os

import pytest

if not os.environ.get('VKIT_TEST_GPU'):
    flags = os.environ.get('XLA_FLAGS', '')
    if '--xla_force_host_platform_device_count' not in flags:
        os.environ['XLA_FLAGS'] = (
            flags + ' --xla_force_host_platform_device_count=8'
        ).strip()
    import jax

    jax.config.update('jax_platforms', 'cpu')


@pytest.fixture(autouse=True)
def _skip_gpu_tests_without_a_card(request):
    """Decided per test, not at import: every worker collects the same
    tests whatever devices it can see."""
    if request.node.get_closest_marker('gpu') is None:
        return
    import jax

    if jax.default_backend() != 'gpu':
        pytest.skip(
            'needs an NVIDIA GPU; run `VKIT_TEST_GPU=1 python -m pytest '
            f'-m gpu tests/` on a card (JAX backend here: '
            f'{jax.default_backend()})'
        )
