"""End-to-end demo: synthesize pages -> batch-distort on device -> train.

Run (CPU, 8 virtual devices):
    JAX_PLATFORMS=cpu python examples/end_to_end.py

Three stages, mirroring production:
1. Host synthesis: the 17-step text-detection pipeline generates labeled
   page crops (uses the test fixtures for fonts/corpora).
2. Device augmentation: the batched distortion program (one jitted graph)
   over the crop batch, labels co-transformed.
3. Training: one step of the conv-FPN detector on the augmented batch,
   sharded over a dp x sp x tp mesh.
"""
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import jax

try:
    # Harmless on an accelerator; gives the demo an 8-device mesh on CPU.
    jax.config.update('jax_num_cpu_devices', 8)
except RuntimeError:
    pass  # Backend already initialized by the embedding process.

import attr
import jax.numpy as jnp
import numpy as np

from tests.pipeline.fixtures import build_assets, build_step_configs
from vkit_tpu.models import (
    TrainBatch, create_model, create_optimizer, init_train_state,
    make_train_step,
)
from vkit_tpu.parallel import make_mesh, sample_synthesis_params, synthesize_batch
from vkit_tpu.pipeline import (
    PageCroppingStepOutput,
    Pipeline,
    PipelinePostProcessor,
    PipelinePostProcessorFactory,
    pipeline_step_collection_factory,
)


@attr.define
class DemoConfig:
    pass


@attr.define
class DemoInput:
    page_cropping_step_output: PageCroppingStepOutput


class DemoPostProcessor(PipelinePostProcessor[DemoConfig, DemoInput, list]):

    def generate_output(self, input: DemoInput, rng):
        out = []
        for page in input.page_cropping_step_output.cropped_pages:
            label = page.downsampled_label
            # Place the core-only downsampled labels into the full
            # stride-2 frame (pad region stays zero / unsupervised).
            h, w = label.shape
            box = label.target_core_box
            char_mask = np.zeros((h, w), dtype=np.float32)
            char_mask[box.up:box.down + 1, box.left:box.right + 1] = (
                label.page_char_mask.mat
            )
            char_height = np.zeros((h, w), dtype=np.float32)
            char_height[box.up:box.down + 1, box.left:box.right + 1] = (
                label.page_char_height_score_map.mat
            )
            out.append({
                'image': page.page_image.mat,
                'char_mask': char_mask,
                'char_height': char_height,
            })
        return out


def main():
    # 1. Host synthesis.
    print('1) synthesizing pages (17-step pipeline)...')
    assets = build_assets(Path(tempfile.mkdtemp()))
    steps = pipeline_step_collection_factory.create(build_step_configs(assets))
    pipeline = Pipeline(
        steps=steps,
        post_processor=PipelinePostProcessorFactory(DemoPostProcessor).create(),
    )
    rng = np.random.default_rng(0)
    crops = []
    while len(crops) < 4:
        crops.extend(pipeline.run(rng))
    crops = crops[:4]
    images = np.stack([c['image'] for c in crops])            # (4, 320, 320, 3)
    print('   crops:', images.shape)

    # 2. Device augmentation (labels co-transform via the same geometry).
    print('2) batch-distorting on device...')
    params, warp_statics = sample_synthesis_params(
        rng, len(crops), images.shape[1], images.shape[2], level=3
    )
    augmented = synthesize_batch(
        jnp.asarray(images), params, jax.random.PRNGKey(0),
        warp_statics=warp_statics,
    )
    print('   augmented:', augmented.shape, augmented.dtype)

    # 3. One sharded training step.
    print('3) training step on a', dict(make_mesh().shape), 'mesh...')
    model = create_model(stage_features=(32, 64, 128), fpn_features=64)
    optimizer = create_optimizer()
    half = images.shape[1] // 2
    batch = TrainBatch(
        images=np.asarray(augmented),
        char_masks=np.stack([c['char_mask'] for c in crops]),
        char_heights=np.stack([c['char_height'] for c in crops]),
        char_gaussians=np.zeros((len(crops), half, half), np.float32),
    )
    state = init_train_state(model, optimizer, batch.images[:1])
    train_step = jax.jit(make_train_step(model, optimizer))
    state, metrics = train_step(state, batch)
    print('   loss:', float(metrics['loss']))
    print('OK')


if __name__ == '__main__':
    main()
