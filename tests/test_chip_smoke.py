"""chip_smoke.py refuses to run anywhere but on a GPU with the repo beside
it: it exits non-zero and prints no result line."""
import json
import os
import shutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def _no_result(proc):
    assert proc.returncode != 0
    lines = proc.stdout.strip().splitlines()
    if lines:
        with pytest.raises(ValueError):
            json.loads(lines[-1])


@pytest.mark.parametrize("args", [[], ["--four"]], ids=["one", "four"])
def test_fails_on_cpu(args):
    proc = _run(args, REPO)
    _no_result(proc)
    assert "not a GPU" in proc.stderr


def test_fails_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    _no_result(_run([], str(tmp_path)))
