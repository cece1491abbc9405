"""Device kernel library (jnp / lax) + host twins.

Submodules that must stay jax-free (imported by the host element layer):
``resize_taps``, ``colorspace_np``.  Everything else may import jax.
"""
from . import colorspace_np, resize_taps  # noqa: F401
from .resize_taps import Interpolation  # noqa: F401

_LAZY = ('resize', 'color', 'warp', 'blur', 'noise', 'blend', 'effect',
         'glyph', 'region', 'cvraster', 'warp_mxu', 'warp_banded')


def __getattr__(name):
    if name in _LAZY:
        import importlib
        module = importlib.import_module(f'.{name}', __name__)
        globals()[name] = module
        return module
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
