"""chip_smoke.py, bench.py and the compile-cache helper, rehearsed on the CPU.

Each smoke phase runs here at its tiny rehearsal sizes on the suite's
virtual CPU devices; the same functions run at full width on the GPU when
``python chip_smoke.py`` is run there.  Without a GPU and without the
rehearsal flag, both scripts must refuse to run.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import pytest

ROOT = pathlib.Path(__file__).parent.parent
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from composablestatespacemodels_tpu.utils import compile_cache  # noqa: E402


@pytest.fixture
def rehearsal(monkeypatch):
    # the cache phase must not point this test process at a cache
    monkeypatch.setenv(compile_cache.ENV_VAR, "/nonexistent/unused")
    return chip_smoke.Smoke(chip_smoke.REHEARSAL, rehearsal=True)


@pytest.fixture
def gpu_smoke():
    """A full-size smoke context; skips unless JAX sees a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run python chip_smoke.py on the card)")
    return chip_smoke.Smoke(chip_smoke.Sizes(), rehearsal=False)


@pytest.mark.parametrize("phase", list(chip_smoke.PHASES))
def test_smoke_phase_rehearsal(phase, rehearsal):
    chip_smoke.PHASES[phase](rehearsal)


@pytest.mark.parametrize("phase", list(chip_smoke.FOUR_CARD_PHASES))
def test_four_card_phase_rehearsal(phase, rehearsal):
    chip_smoke.FOUR_CARD_PHASES[phase](rehearsal)


@pytest.mark.gpu
def test_kalman_gate_on_gpu(gpu_smoke):
    chip_smoke.phase_kalman(gpu_smoke)


def _run_script(args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_scripts_refuse_without_gpu(script):
    r = _run_script([script])
    assert r.returncode != 0
    assert "no GPU" in r.stderr
    assert '"ok"' not in r.stdout and '"value"' not in r.stdout


def test_chip_smoke_rehearsal_last_line():
    r = _run_script(["chip_smoke.py", "--cpu-rehearsal", "--four-cards"])
    assert r.returncode == 0, r.stderr[-2000:]
    last = json.loads(r.stdout.strip().splitlines()[-1])
    assert last == {"ok": True, "device": {"platform": "cpu",
                                           "kind": "cpu", "count": 4}}


def test_compile_cache_env_set_is_honoured(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, "/some/where")
    assert compile_cache.configure_compile_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_fixed_repo_dir(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
    try:
        got = compile_cache.configure_compile_cache()
        assert got == str(ROOT / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
        # the same path on every call (never a temporary or per-run name)
        assert compile_cache.configure_compile_cache() == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
