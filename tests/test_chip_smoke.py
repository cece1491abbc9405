"""chip_smoke.py on the CPU: it refuses to run, and every phase function
passes at a tiny size (the card run uses the same functions at real
widths)."""
import jax

import chip_smoke


def test_main_refuses_without_a_gpu(capsys):
    assert chip_smoke.main([]) != 0
    captured = capsys.readouterr()
    assert "platform 'cpu'" in captured.err
    assert '"ok"' not in captured.out


def test_identity_primitives_precision():
    devices = chip_smoke.phase_identity(None, require_gpu=False)
    assert devices[0].platform == 'cpu'
    chip_smoke.phase_primitives(batch=2, side=64)
    chip_smoke.phase_precision(batch=1, side=64, coord_shape=(300, 212))


def test_warp_routes_and_random_distortion():
    chip_smoke.phase_warp_routes(batch=4, side=160, canvas=(176, 176))
    chip_smoke.phase_random_distortion(batch=4, side=96, canvas=(112, 112))


def test_end_to_end_phases(tmp_path, capsys):
    chip_smoke.phase_end_to_end('f', (192, 192), 2, 1, 'cpu', tmp_path,
                                crop_size=96)
    chip_smoke.phase_end_to_end('g', (272, 192), 1, 1, 'cpu', tmp_path,
                                crop_size=96)
    out = capsys.readouterr().out
    assert out.count('synthesize_stream') == 2


def test_four_card_phase_on_virtual_devices():
    devices = jax.devices()
    assert len(devices) >= 4
    chip_smoke.phase_four_cards(devices[:4], per_card=1, side=160)


def test_gpu_tests_skip_on_cpu(monkeypatch):
    monkeypatch.setenv('VKIT_TEST_GPU', '0')
    counts = chip_smoke.phase_gpu_tests(require_run=False)
    assert counts['failed'] == 0 and counts['passed'] == 0
    assert counts['skipped'] > 0

