"""The compile counter the bench and the chip smoke read, and the
persistent compile cache's placement."""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from vkit_tpu.utility import compilation

REPO = Path(__file__).resolve().parents[2]


def test_counter_counts_each_fresh_compile_once():
    compilation.install_compile_counter()
    fn = jax.jit(lambda x: jnp.sin(x) * 3.0 + 1.0)
    x = jax.device_put(np.ones((3, 5, 11), np.float32))
    before = compilation.compile_count()
    seconds = compilation.compile_seconds()
    fn(x)                                    # unique shape: one compile
    assert compilation.compile_count() == before + 1
    assert compilation.compile_seconds() > seconds
    assert '<lambda>' in compilation.recent_compile_names(1)[0]
    fn(x)                                    # same program: no compile
    assert compilation.compile_count() == before + 1


def test_counter_install_is_idempotent():
    compilation.install_compile_counter()
    compilation.install_compile_counter()
    x = jax.device_put(np.arange(13.0, dtype=np.float32))
    before = compilation.compile_count()
    out = jax.jit(lambda v: v * 2.0)(x)
    np.testing.assert_allclose(np.asarray(out), np.arange(13.0) * 2.0)
    assert compilation.compile_count() == before + 1


def test_cache_lands_in_the_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing and the
    cache is written there."""
    cache = tmp_path / 'cache'
    script = (
        'import jax, jax.numpy as jnp\n'
        'from vkit_tpu.utility import enable_compilation_cache\n'
        'where = enable_compilation_cache()\n'
        'assert where == jax.config.jax_compilation_cache_dir, where\n'
        'jax.jit(lambda x: jnp.cos(x) + 2.0)(jnp.ones(7)).block_until_ready()\n'
        'print(where)\n'
    )
    env = dict(os.environ, JAX_PLATFORMS='cpu',
               JAX_COMPILATION_CACHE_DIR=str(cache),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS='0',
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, '-c', script], env=env,
                          capture_output=True, text=True, timeout=300,
                          cwd=tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == str(cache)
    assert any(cache.iterdir())


def test_cache_defaults_to_the_repo_dir(monkeypatch):
    monkeypatch.delenv('JAX_COMPILATION_CACHE_DIR', raising=False)
    saved = jax.config.jax_compilation_cache_dir
    try:
        where = compilation.enable_compilation_cache()
        assert where == str(REPO / '.jax_cache')
        assert jax.config.jax_compilation_cache_dir == where
    finally:
        jax.config.update('jax_compilation_cache_dir', saved)
