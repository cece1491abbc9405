"""Measure the ACTUAL reference 17-step text-detection pipeline end to end.

The reference (vkit @ /root/reference) runs via tools/refshims — including
PIL-backed freetype, first-party barcode/rectpack/faker stand-ins — over
the same synthetic assets the device synth bench uses
(tests/pipeline/fixtures.build_assets: DejaVu fonts, corpus lines, bg and
symbol images, ASCII lexicon).  This produces the legitimate
samples-per-second baseline for bench config 6 (the full page-synthesis
row): the reference's own Pipeline.run on this host's CPU.

Usage: python tools/measure_reference_pipeline.py [--num-seeds 6]
Writes the result into BASELINE_REF.json
(`reference_pipeline_17step_samples_per_sec`).
"""
import argparse
import json
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / 'tools' / 'refshims'))
sys.path.insert(0, '/root/reference')
sys.path.insert(0, str(REPO))

import os
os.environ.setdefault('DISABLE_VKIT_COLLECT_USAGE_INFORMATION', '1')

import numpy as np  # noqa: E402

# cv2 >= 5 rejects read-only draw targets (the reference draws into frozen
# element mats); shim writable copies for the draw entry points it uses.
import cv2  # noqa: E402

for _name in ('ellipse', 'fillPoly', 'line', 'rectangle'):
    _orig = getattr(cv2, _name)

    def _compat(img, *args, _orig=_orig, **kwargs):
        if isinstance(img, np.ndarray) and not img.flags.writeable:
            img = img.copy()
        return _orig(img, *args, **kwargs)

    setattr(cv2, _name, _compat)


def build_reference_pipeline(assets):
    import attrs
    from vkit.pipeline import (
        Pipeline,
        PipelinePostProcessor,
        PipelinePostProcessorFactory,
        pipeline_step_collection_factory,
    )
    from vkit.pipeline.text_detection.page_cropping import (
        PageCroppingStepOutput,
    )

    from tests.pipeline.fixtures import build_step_configs

    steps = pipeline_step_collection_factory.create(
        build_step_configs(assets)
    )

    @attrs.define
    class _CountConfig:
        pass

    @attrs.define
    class _CountInput:
        page_cropping_step_output: PageCroppingStepOutput

    class _CountPostProcessor(
        PipelinePostProcessor[_CountConfig, _CountInput, int]
    ):

        def generate_output(self, input: _CountInput, rng) -> int:
            return len(input.page_cropping_step_output.cropped_pages)

    post = PipelinePostProcessorFactory(_CountPostProcessor).create()
    return Pipeline(steps=steps, post_processor=post)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--num-seeds', type=int, default=6)
    args = parser.parse_args()

    from tests.pipeline.fixtures import build_assets

    assets = build_assets(Path('/tmp/ref_pipeline_assets'))
    pipeline = build_reference_pipeline(assets)

    # Warm one run (font loading, engine init).
    pipeline.run(np.random.default_rng(0))

    begin = time.perf_counter()
    done = 0
    for seed in range(1, args.num_seeds + 1):
        for attempt in range(3):
            try:
                pipeline.run(np.random.default_rng(seed * 97 + attempt))
                done += 1
                break
            except Exception as exc:  # noqa: BLE001 - retry like the pool
                print(f'seed {seed} attempt {attempt}: {type(exc).__name__}: '
                      f'{exc}', flush=True)
    elapsed = time.perf_counter() - begin
    assert done, 'no reference pipeline run succeeded'
    rate = done / elapsed
    print(f'reference 17-step pipeline: {done} pages in {elapsed:.1f}s '
          f'-> {rate:.3f} samples/s')

    path = REPO / 'BASELINE_REF.json'
    data = json.loads(path.read_text()) if path.exists() else {}
    data['reference_pipeline_17step_samples_per_sec'] = round(rate, 4)
    data['reference_pipeline_17step_num_seeds'] = done
    path.write_text(json.dumps(data, indent=2) + '\n')
    print(f'wrote {path}')


if __name__ == '__main__':
    main()
