"""chip_smoke.py must refuse to report success without a GPU."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


def _run(args, cwd=ROOT):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu(tmp_path):
    proc = _run([SCRIPT])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "GPU" in proc.stderr
    # alone in a directory, without the package beside it
    lone = tmp_path / "chip_smoke.py"
    shutil.copy(SCRIPT, lone)
    proc = _run([str(lone)], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_four_needs_four_gpus():
    proc = _run([SCRIPT, "--four"])
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs 4 GPU(s)" in proc.stderr
