"""vkit_tpu — accelerator-batched synthetic-data framework for document OCR.

A ground-up JAX/XLA rebuild of the capability set of vkit-x/vkit (reference
layout: utility / element / mechanism / engine / pipeline).  Dense per-pixel
work runs batched on the accelerator (an NVIDIA GPU); the host keeps label
algebra (backed by a first-party C++ geometry library), font/corpus I/O, and
pipeline assembly.
"""

__version__ = '0.1.0'

# Subpackages import lazily; ``import vkit_tpu`` stays cheap and never touches
# the device.  (The reference phones home on import — vkit/__init__.py:14-17 —
# which is deliberately NOT replicated.)
from . import utility  # noqa: F401

_LAZY_SUBMODULES = (
    'element',
    'ops',
    'mechanism',
    'engine',
    'pipeline',
    'parallel',
    'geometry',
    'models',
)


def __getattr__(name):
    if name in _LAZY_SUBMODULES:
        import importlib
        module = importlib.import_module(f'.{name}', __name__)
        globals()[name] = module
        return module
    raise AttributeError(f'module {__name__!r} has no attribute {name!r}')
