"""Environment contracts: compile-cache location, the solve path's
dependencies, and the chip smoke test's refusal to run without a GPU.
Each runs in a fresh CPU subprocess, so JAX config set at import is the
subprocess's own."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]


def _run(code_or_args, env_extra=None, cwd=REPO, timeout=240):
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    env.update(env_extra or {})
    args = (code_or_args if isinstance(code_or_args, list)
            else [sys.executable, "-c", code_or_args])
    return subprocess.run(args, cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=timeout)


@pytest.mark.parametrize("explicit", [True, False])
def test_compile_cache_dir(tmp_path, explicit):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the fixed
    in-checkout .jax_cache/ (a fixed path, so cache keys stay stable)."""
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)} if explicit else {}
    r = _run("import jax, mac_tpu; print(jax.config.jax_compilation_cache_dir)",
             env)
    assert r.returncode == 0, r.stderr
    want = str(tmp_path) if explicit else str(REPO / ".jax_cache")
    assert r.stdout.strip().splitlines()[-1] == want


def test_solver_import_needs_no_networkx():
    """The main path needs numpy, scipy and JAX only: networkx is imported
    lazily by the conversion helpers."""
    r = _run("import sys, mac_tpu.solvers, mac_tpu.slam.pose_graph, "
             "mac_tpu.utils; print('networkx' in sys.modules)")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "False"


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_refuses_without_gpu(tmp_path, alone):
    """chip_smoke.py exits nonzero and prints no result line when JAX finds
    no GPU — in the checkout, and alone in an otherwise empty directory."""
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    r = _run([sys.executable, str(script)], cwd=cwd,
             env_extra={"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "not 'gpu'" in r.stderr
