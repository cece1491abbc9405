"""Step-level timing + device trace capture.

The reference ships no tracing (SURVEY.md §5: only an uninstrumented
profile_* test hook).  Here: a lightweight step timer the pipeline/driver
can wrap around stages, and a context manager for jax profiler traces
(viewable in XProf/TensorBoard).
"""
import contextlib
import json
import logging
import time
from collections import defaultdict
from typing import Dict, Optional

logger = logging.getLogger(__name__)


class StepTimer:
    """Accumulates wall-clock per named stage; cheap enough to leave on."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def measure(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.totals[name] += elapsed
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                'total_sec': round(self.totals[name], 4),
                'count': self.counts[name],
                'mean_ms': round(self.totals[name] / self.counts[name] * 1e3, 3),
            }
            for name in sorted(self.totals, key=self.totals.get, reverse=True)
        }

    def log_summary(self, header: str = 'step timings'):
        logger.info('%s: %s', header, json.dumps(self.summary()))

    def reset(self):
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def device_trace(log_dir: str, enabled: bool = True):
    """jax profiler trace context (XProf); no-op when disabled."""
    if not enabled:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


_HOST_ALLOC_TUNED = False


def tune_host_allocator():
    """Raise glibc's mmap threshold so big numpy temporaries recycle
    through the arena instead of fresh mmaps (idempotent).

    On Firecracker VMs first-touch page faults run ~100x slow; without
    this, every per-batch (N, H, W) map/stack allocation pays seconds of
    fault time.  Measured 5-10x on the warp-planning host stages.
    """
    global _HOST_ALLOC_TUNED
    if _HOST_ALLOC_TUNED:
        return
    _HOST_ALLOC_TUNED = True
    try:
        import ctypes

        libc = ctypes.CDLL('libc.so.6', use_errno=True)
        M_MMAP_THRESHOLD = -3
        libc.mallopt(M_MMAP_THRESHOLD, 1 << 30)
    except Exception:  # noqa: BLE001 - non-glibc platforms
        pass
