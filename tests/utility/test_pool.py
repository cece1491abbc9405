"""Producer pool: thread and process modes, retry semantics, PipelinePool."""
import numpy as np

from vkit_tpu.utility.pool import Pool, PoolConfig


def _produce(worker_idx, rng, config):
    return (worker_idx, float(rng.random()))


def test_thread_pool_produces_and_cleans_up():
    pool = Pool(
        PoolConfig(inventory=4, num_processes=2, rng_seed=11, timeout=10),
        _produce,
    )
    items = [pool.run() for _ in range(8)]
    assert len(items) == 8
    assert {idx for idx, _ in items} <= {0, 1}
    pool.cleanup()
    assert not pool.workers


def test_process_pool_produces_and_cleans_up():
    pool = Pool(
        PoolConfig(
            # Spawn-mode workers re-import the package (incl. jax); on this
            # single-core host that takes tens of seconds under load.
            inventory=4, num_processes=2, rng_seed=11, timeout=120,
            use_processes=True,
        ),
        _produce,
    )
    items = [pool.run() for _ in range(8)]
    assert len(items) == 8
    assert {idx for idx, _ in items} <= {0, 1}
    pool.cleanup()
    assert not pool.workers


def _worker_platforms(worker_idx, rng, config):
    import os

    return os.environ.get('JAX_PLATFORMS')


def test_process_pool_workers_hide_the_device(monkeypatch):
    """Process workers start on the CPU platform whatever the parent
    runs on, and the parent's environment is left as it was."""
    monkeypatch.setenv('JAX_PLATFORMS', 'cuda')
    pool = Pool(
        PoolConfig(inventory=2, num_processes=1, rng_seed=3, timeout=120,
                   use_processes=True),
        _worker_platforms,
    )
    try:
        assert pool.run() == 'cpu'
    finally:
        pool.cleanup()
    import os

    assert os.environ['JAX_PLATFORMS'] == 'cuda'


def _flaky(worker_idx, rng, config):
    value = float(rng.random())
    if value < 0.5:
        raise RuntimeError('flaky')
    return value


def test_pool_retries_on_exception():
    pool = Pool(
        PoolConfig(inventory=2, num_processes=1, rng_seed=0, timeout=30),
        _flaky,
    )
    values = [pool.run() for _ in range(4)]
    assert all(v >= 0.5 for v in values)
    pool.cleanup()


def test_pipeline_pool():
    import attr

    from vkit_tpu.pipeline import (
        Pipeline,
        PipelinePool,
        PipelinePostProcessor,
        PipelinePostProcessorFactory,
        PipelineState,
        PipelineStep,
        PipelineStepFactory,
    )

    @attr.define
    class TinyStepConfig:
        lo: int = 0
        hi: int = 100

    @attr.define
    class TinyStepInput:
        pass

    @attr.define
    class TinyStepOutput:
        value: int

    class TinyStep(PipelineStep[TinyStepConfig, TinyStepInput, TinyStepOutput]):

        def run(self, input: TinyStepInput, rng):
            return TinyStepOutput(
                value=int(rng.integers(self.config.lo, self.config.hi))
            )

    @attr.define
    class OutCfg:
        pass

    @attr.define
    class OutInput:
        tiny_step_output: TinyStepOutput

    class OutProcessor(PipelinePostProcessor[OutCfg, OutInput, int]):

        def generate_output(self, input: OutInput, rng):
            return input.tiny_step_output.value

    pipeline = Pipeline(
        steps=[PipelineStepFactory(TinyStep).create()],
        post_processor=PipelinePostProcessorFactory(OutProcessor).create(),
    )
    pool = PipelinePool(
        pipeline, inventory=4, num_processes=2, rng_seed=7, timeout=30
    )
    values = [pool.run() for _ in range(10)]
    assert len(values) == 10
    assert all(0 <= v < 100 for v in values)
    assert len(set(values)) > 1
    pool.cleanup()


# --- spawn-mode pipeline pool (JAX-safe): module-level, picklable ----------

import attr as _attr

from vkit_tpu.pipeline import (
    Pipeline as _Pipeline,
    PipelinePool as _PipelinePool,
    PipelinePostProcessor as _PostProcessor,
    PipelinePostProcessorFactory as _PostProcessorFactory,
    PipelineStep as _Step,
    PipelineStepFactory as _StepFactory,
)


@_attr.define
class SpawnStepConfig:
    hi: int = 1000


@_attr.define
class SpawnStepInput:
    pass


@_attr.define
class SpawnStepOutput:
    value: int


class SpawnStep(_Step[SpawnStepConfig, SpawnStepInput, SpawnStepOutput]):

    def run(self, input: SpawnStepInput, rng):
        return SpawnStepOutput(value=int(rng.integers(0, self.config.hi)))


@_attr.define
class SpawnOutCfg:
    pass


@_attr.define
class SpawnOutInput:
    spawn_step_output: SpawnStepOutput


class SpawnOutProcessor(_PostProcessor[SpawnOutCfg, SpawnOutInput, int]):

    def generate_output(self, input: SpawnOutInput, rng):
        return input.spawn_step_output.value


def build_spawn_pipeline() -> '_Pipeline':
    return _Pipeline(
        steps=[_StepFactory(SpawnStep).create()],
        post_processor=_PostProcessorFactory(SpawnOutProcessor).create(),
    )


def test_pipeline_pool_spawn_with_jax(recwarn):
    """Process pool via spawn stays deadlock-free next to live JAX work."""
    import warnings

    import jax
    import jax.numpy as jnp

    # Initialize JAX threads in the parent BEFORE starting the pool: this
    # is exactly the combination that deadlocks forked children.
    x = jnp.ones((64, 64))
    float(jax.jit(lambda a: (a @ a).sum())(x))

    with warnings.catch_warnings():
        warnings.simplefilter('error', RuntimeWarning)  # os.fork() warns
        pool = _PipelinePool(
            pipeline_factory=build_spawn_pipeline,
            inventory=4,
            num_processes=2,
            rng_seed=3,
            timeout=120,
        )
        try:
            # Interleave device work with pool consumption.
            values = []
            for _ in range(6):
                values.append(pool.run())
                float(jax.jit(lambda a: (a * 2).sum())(x))
        finally:
            pool.cleanup()
    assert len(values) == 6 and all(0 <= v < 1000 for v in values)
