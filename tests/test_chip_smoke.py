"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phases work at tiny sizes (kernels in interpret mode)."""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_main_refuses_the_cpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_script_alone_fails(tmp_path):
    """Run as the driver runs it, from a directory holding nothing else
    of the repository: non-zero exit, no result line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_phase_reference_deployment(tmp_path):
    rec = chip_smoke.phase_reference_deployment(
        str(tmp_path / "out"), particles=4096, frames=2
    )
    assert rec["frames"] == 3 and rec["particles"] == 4096


def test_phase_bench_width():
    res = chip_smoke.phase_bench_width(None, particles=2048, steps=2)
    assert res["detail"]["timed_flags"] == 0
    assert res["detail"]["n"] == 2048


def test_phase_kernels():
    out = chip_smoke.phase_kernels(
        interpret=True, big=2048, small=1024, settle_frames=1,
        oracle_rows=64,
    )
    for key in ("big", "small", "oracle"):
        assert out[key]["density_rms"] < 1e-5, (key, out[key])
    json.dumps(out)


def test_phase_four_cards():
    """The four-card comparison, on 4 virtual CPU devices (tiles path)."""
    if len(jax.devices()) < 4:
        pytest.skip("needs the virtual CPU mesh")
    rec = chip_smoke.phase_four_cards(particles=2048, substeps=2)
    assert rec["density_rms"] < 2e-5
