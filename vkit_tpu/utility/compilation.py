"""XLA compilation: the persistent cache and the compile counter.

The counter listens to JAX's backend-compile event (``jax.monitoring``),
which fires once for every program XLA is asked to build, persistent-cache
hits included, with its duration.  The benchmark and the chip smoke read
it: a steady window compiles nothing, and compile seconds are set-up.
"""
import os
import threading
from pathlib import Path

_REPO_CACHE = Path(__file__).resolve().parents[2] / '.jax_cache'

_BACKEND_COMPILE_EVENT = '/jax/core/compile/backend_compile_duration'

_lock = threading.Lock()
_log = {'installed': False, 'count': 0, 'seconds': 0.0, 'names': []}


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compile cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here.  Otherwise the cache lives at the repository's
    fixed ``.jax_cache``: the path is part of the cache key, so a moving
    directory would never hit.
    """
    env_dir = os.environ.get('JAX_COMPILATION_CACHE_DIR')
    if env_dir:
        return env_dir
    import jax

    jax.config.update('jax_compilation_cache_dir', str(_REPO_CACHE))
    return str(_REPO_CACHE)


def _on_duration(event: str, duration_secs: float, **kwargs) -> None:
    if event != _BACKEND_COMPILE_EVENT:
        return
    with _lock:
        _log['count'] += 1
        _log['seconds'] += duration_secs
        _log['names'].append(str(kwargs.get('fun_name', '<unnamed>')))
        if len(_log['names']) > 512:
            del _log['names'][:256]


def install_compile_counter() -> None:
    """Start counting compiles in this process (idempotent)."""
    with _lock:
        if _log['installed']:
            return
        _log['installed'] = True
    import jax

    jax.monitoring.register_event_duration_secs_listener(_on_duration)


def compile_count() -> int:
    """XLA compile requests since the counter was installed or reset."""
    install_compile_counter()
    return _log['count']


def compile_seconds() -> float:
    """Seconds spent in those compile requests."""
    install_compile_counter()
    return _log['seconds']


def recent_compile_names(limit: int = 20):
    """Names of the most recently compiled programs (diagnostics)."""
    with _lock:
        return list(_log['names'][-limit:])

