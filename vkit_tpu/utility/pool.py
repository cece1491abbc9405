"""Sample-generation pool with inventory backpressure.

Capability parity: vkit/utility/pool.py:31-243 (PoolWorkerProtocol, PoolConfig,
Pool).  Re-designed for an accelerator host: a data-generation *prefetch pump*
whose backpressure semantics (inventory target, scheduled-count accounting,
retry-on-exception) match the reference pool, but whose workers are either

* threads (default; the dense work happens on the device under jit, which
  releases the GIL, so threads overlap host prep with device compute), or
* processes (``use_processes=True``; mirrors the reference multiprocessing
  pool for pure-host workloads).  They start with ``JAX_PLATFORMS=cpu``:
  a JAX process reserves most of an accelerator's memory when it first
  touches it, so N workers must not each open the card the parent uses.

Per-worker RNG streams derive from ``SeedSequence(seed).spawn(num_workers)``
exactly like vkit/utility/pool.py:86-87.
"""
import contextlib
import logging
import os
import queue
import threading
from typing import Any, Callable, Generic, Optional, Protocol, TypeVar

import attr
import numpy as np
from numpy.random import Generator as RandomGenerator

logger = logging.getLogger(__name__)

_T_ITEM = TypeVar('_T_ITEM')


class PoolWorkerProtocol(Protocol[_T_ITEM]):

    def __init__(self, process_idx: int, seed: int, logger: logging.Logger, config: Any):
        ...

    def run(self, rng: RandomGenerator) -> _T_ITEM:
        ...


@attr.define
class PoolConfig:
    inventory: int
    num_processes: int
    rng_seed: int = 13370
    schedule_size_min_factor: float = 1.0
    timeout: Optional[float] = None
    use_processes: bool = False
    # 'spawn' is JAX-safe (no fork of a multithreaded parent); 'fork' only
    # works with non-picklable closure workers and pre-JAX parents.
    mp_start_method: str = 'spawn'


class _Worker(threading.Thread):

    def __init__(self, idx: int, seed_seq: np.random.SeedSequence, func: Callable, config: Any,
                 out_queue: 'queue.Queue', stop_event: threading.Event):
        super().__init__(daemon=True)
        self.idx = idx
        self.rng = np.random.default_rng(seed_seq)
        self.func = func
        self.config = config
        self.out_queue = out_queue
        self.stop_event = stop_event

    def run(self):
        while not self.stop_event.is_set():
            try:
                item = self.func(self.idx, self.rng, self.config)
            except Exception:
                logger.exception('pool worker %d failed; retrying with advanced rng', self.idx)
                # Force the rng stream forward so a deterministic failure does
                # not loop forever (mirrors vkit/pipeline/pool.py:67-83).
                self.rng.random()
                continue
            while not self.stop_event.is_set():
                try:
                    self.out_queue.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue


def _process_worker_main(idx, seed_seq, func, config, out_queue):
    rng = np.random.default_rng(seed_seq)
    while True:
        try:
            item = func(idx, rng, config)
        except Exception:
            logger.exception(
                'pool process %d failed; retrying with advanced rng', idx
            )
            rng.random()
            continue
        out_queue.put(item)  # Blocks at maxsize: the backpressure knob.


@contextlib.contextmanager
def _device_hidden_environ():
    """Spawned children copy the parent's environment at start: hide the
    accelerator from them for the duration of the starts."""
    saved = os.environ.get('JAX_PLATFORMS')
    os.environ['JAX_PLATFORMS'] = 'cpu'
    try:
        yield
    finally:
        if saved is None:
            del os.environ['JAX_PLATFORMS']
        else:
            os.environ['JAX_PLATFORMS'] = saved


class Pool(Generic[_T_ITEM]):
    """Bounded-inventory producer pool.

    ``func(worker_idx, rng, config) -> item`` runs in ``num_processes``
    workers; items buffer in a queue of size ``inventory`` (the backpressure
    knob, equivalent to the reference's inventory/num_scheduled accounting at
    vkit/utility/pool.py:136-151).

    ``use_processes=True`` forks real processes (the host-synthesis pipeline
    is Python-bound, so threads alone cannot scale it); teardown mirrors the
    reference's psutil terminate -> wait(3) -> kill
    (vkit/utility/pool.py:189-218) with Process.terminate/join/kill.
    """

    def __init__(self, config: PoolConfig, func: Callable[[int, RandomGenerator, Any], _T_ITEM],
                 worker_config: Any = None):
        self.config = config
        self.stop_event = threading.Event()
        seed_seqs = np.random.SeedSequence(config.rng_seed).spawn(config.num_processes)

        if config.use_processes:
            import multiprocessing as mp
            ctx = mp.get_context(config.mp_start_method)
            self.queue = ctx.Queue(maxsize=max(1, config.inventory))
            self.workers = [
                ctx.Process(
                    target=_process_worker_main,
                    args=(idx, seed_seqs[idx], func, worker_config, self.queue),
                    daemon=True,
                )
                for idx in range(config.num_processes)
            ]
        else:
            self.queue = queue.Queue(maxsize=max(1, config.inventory))
            self.workers = [
                _Worker(idx, seed_seqs[idx], func, worker_config, self.queue, self.stop_event)
                for idx in range(config.num_processes)
            ]
        if config.use_processes:
            with _device_hidden_environ():
                for worker in self.workers:
                    worker.start()
        else:
            for worker in self.workers:
                worker.start()

    def run(self) -> _T_ITEM:
        return self.queue.get(timeout=self.config.timeout)

    def __iter__(self):
        while True:
            yield self.run()

    def cleanup(self):
        self.stop_event.set()
        for worker in self.workers:
            if isinstance(worker, threading.Thread):
                worker.join(timeout=3.0)
            else:
                # terminate -> wait(3) -> kill, like the reference.
                worker.terminate()
                worker.join(timeout=3.0)
                if worker.is_alive():
                    worker.kill()
                    worker.join(timeout=1.0)
        self.workers = []

    def __del__(self):
        try:
            self.stop_event.set()
        except Exception:
            pass
