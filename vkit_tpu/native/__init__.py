"""Native (C++) host kernels, loaded via ctypes.

The reference's host-side hot loops live in native libraries (OpenCV
rasterization/contours, GEOS, Clipper); this package is the first-party
equivalent.  The shared library is built from ``geometry.cpp`` on the
machine that loads it (g++, ~1 s on first import) into ``build/``, under a
name keyed by the source hash, the compile flags and the host, so a
library built elsewhere is never reused.  If g++ is missing or the build
fails, the pure-python implementations in vkit_tpu/geometry/_numpy_impl.py
take over and ``load_library`` returns None.
"""
import ctypes
import hashlib
import logging
import os
import platform
import subprocess
import tempfile
from pathlib import Path
from typing import Optional

logger = logging.getLogger(__name__)

_SRC = Path(__file__).resolve().parent / 'geometry.cpp'
_BUILD_DIR = Path(__file__).resolve().parent / 'build'
# Portable code generation: no -march=native, so the library matches any
# x86-64 host it is built on; FP contraction off keeps results bit-stable.
_FLAGS = ('-O3', '-ffp-contract=off', '-funroll-loops', '-shared', '-fPIC')

_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where this host's build of the geometry library lives."""
    key = hashlib.sha256(
        _SRC.read_bytes()
        + ' '.join(_FLAGS).encode()
        + f'{platform.node()}|{platform.machine()}'.encode()
    ).hexdigest()[:16]
    return _BUILD_DIR / f'libvkitgeom-{key}.so'


def _build(target: Path) -> bool:
    target.parent.mkdir(parents=True, exist_ok=True)
    # Build under a private name, then rename: concurrent importers (test
    # workers) never load a half-written library.
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=target.parent)
    os.close(fd)
    try:
        subprocess.run(
            ['g++', *_FLAGS, str(_SRC), '-o', tmp],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, target)
        return True
    except (OSError, subprocess.SubprocessError):
        logger.exception('native geometry build failed; using numpy fallback')
        return False
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_library() -> Optional[ctypes.CDLL]:
    """Build (if this host has no build yet) and load the geometry
    library; None when it cannot be built or loaded."""
    global _lib
    if _lib is not None:
        return _lib
    if os.environ.get('VKIT_TPU_DISABLE_NATIVE'):
        return None
    target = library_path()
    if not target.exists() and not _build(target):
        return None
    try:
        lib = ctypes.CDLL(str(target))
    except OSError:
        logger.exception('native geometry load failed; using numpy fallback')
        return None

    lib.vg_fill_poly.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
    ]
    lib.vg_fill_poly.restype = None
    lib.vg_label8.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int32),
    ]
    lib.vg_label8.restype = ctypes.c_int
    lib.vg_trace_boundary.argtypes = [
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_double), ctypes.c_longlong,
    ]
    lib.vg_trace_boundary.restype = ctypes.c_int
    f32p = ctypes.POINTER(ctypes.c_float)
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.vg_remap_f32.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        f32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p,
    ]
    lib.vg_remap_f32.restype = None
    lib.vg_resize_f32.argtypes = [
        f32p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        i32p, f32p, ctypes.c_int, ctypes.c_int,
        i32p, f32p, ctypes.c_int, ctypes.c_int,
        f32p, f32p,
    ]
    lib.vg_resize_f32.restype = None
    f64p = ctypes.POINTER(ctypes.c_double)
    if hasattr(lib, 'vg_lattice_node_maps'):
        lib.vg_lattice_node_maps.argtypes = [
            f64p, f64p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            i32p, ctypes.c_int, i32p, ctypes.c_int,
            f32p, f32p, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vg_lattice_node_maps.restype = None
    if hasattr(lib, 'vg_cell_mats'):
        lib.vg_cell_mats.argtypes = [
            f64p, f64p, ctypes.c_int,
            f64p, f64p, ctypes.POINTER(ctypes.c_uint8),
        ]
        lib.vg_cell_mats.restype = None
    if hasattr(lib, 'vg_repair_backward_maps'):
        lib.vg_repair_backward_maps.argtypes = [
            f64p, f64p, ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int, ctypes.c_int,
        ]
        lib.vg_repair_backward_maps.restype = None

    _lib = lib
    return lib
