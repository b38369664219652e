"""`chip_smoke.py` must refuse to run anywhere but on a GPU, and print no
result when it does."""

import os
import shutil
import subprocess
import sys

import pytest

import chip_smoke
from densemonoslam_tpu import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_device_check_fails_on_cpu(argv, capsys):
    assert chip_smoke.main(argv) != 0
    assert "ok" not in capsys.readouterr().out


def test_fails_without_the_package(tmp_path):
    """Alone in a directory, the script exits non-zero before touching JAX."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True,
        text=True, timeout=120, env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    assert proc.returncode != 0
    assert proc.stdout == ""


def test_cli_platform_gpu_fails_on_cpu():
    with pytest.raises(RuntimeError, match="no GPU"):
        cli.main(["--platform", "gpu", "--frames", "1"])
