"""Run every example CLI end-to-end at tiny sizes (guards example rot).

Each app's ``main()`` is executed in-process with patched argv; file
outputs are checked for shape/content.
"""

import pathlib
import runpy
import sys

import numpy as np
import pytest

ROOT = pathlib.Path(__file__).parent.parent


@pytest.fixture(autouse=True)
def _no_cache_config(monkeypatch):
    # the examples configure the compile cache; with the variable set the
    # helper leaves this test process's JAX config untouched
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(ROOT / ".jax_cache"))


def run_example(script, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", [script] + argv)
    monkeypatch.syspath_prepend(str(ROOT))
    runpy.run_path(str(ROOT / "examples" / script), run_name="__main__")


def test_simulate_model_and_filtering(tmp_path, monkeypatch):
    out = str(tmp_path / "d")
    run_example("simulate.py", ["model", "--n-obs", "60", "--out", out],
                monkeypatch)
    sims = open(out + "_sims.csv").read().strip().split("\n")
    assert len(sims) == 60
    assert len(sims[0].split(",")) == 4 + 9  # t,y,eta,gamma + 9 state dims

    run_example("filtering.py",
                [out + "_sims.json", "--n-particles", "100", "--out",
                 str(tmp_path / "f"), "--plot"], monkeypatch)
    rows = open(str(tmp_path / "f") + "_filtered.csv").read().strip()
    assert len(rows.split("\n")) == 60
    png = str(tmp_path / "f") + "_filtered.png"
    assert pathlib.Path(png).exists()
    assert pathlib.Path(png).stat().st_size > 2000

    # multi-chip variant: same app over the virtual device mesh
    run_example("filtering.py",
                [out + "_sims.json", "--n-particles", "128", "--out",
                 str(tmp_path / "fm"), "--mesh"], monkeypatch)
    rows_m = open(str(tmp_path / "fm") + "_filtered.csv").read().strip()
    assert len(rows_m.split("\n")) == 60


def test_simulate_ornstein(tmp_path, monkeypatch):
    out = str(tmp_path / "ou")
    run_example("simulate.py", ["ornstein", "--n-obs", "50", "--out", out],
                monkeypatch)
    rows = open(out + "_ou.csv").read().strip().split("\n")
    assert len(rows) == 51


def test_simulate_lgcp(tmp_path, monkeypatch):
    out = str(tmp_path / "lg")
    run_example("simulate.py", ["lgcp", "--out", out], monkeypatch)
    assert pathlib.Path(out + "_lgcp.csv").exists()


def test_determine_parameters_pipeline(tmp_path, monkeypatch):
    out = str(tmp_path / "d")
    run_example("simulate.py", ["model", "--n-obs", "40", "--out", out],
                monkeypatch)
    run_example("determine_parameters.py",
                ["posterior", out + "_sims.json", "--n-iters", "30",
                 "--n-particles", "50", "--chains", "2", "--out",
                 str(tmp_path / "p")], monkeypatch)
    post = str(tmp_path / "p") + "_posterior_0.json"
    assert len(open(post).read().strip().split("\n")) == 30

    run_example("determine_parameters.py",
                ["tocsv", post, str(tmp_path / "post.csv")], monkeypatch)
    header = open(str(tmp_path / "post.csv")).readline().split(",")
    assert header[0] == "scale"


def test_interpolate(tmp_path, monkeypatch):
    run_example("interpolate.py",
                ["--n-obs", "50", "--knock-lo", "20", "--knock-hi", "30",
                 "--n-particles", "100", "--out", str(tmp_path / "i")],
                monkeypatch)
    rows = open(str(tmp_path / "i") + "_interpolated.csv").read().strip()
    arr = np.asarray([r.split(",") for r in rows.split("\n")], dtype=float)
    assert arr.shape == (50, 5)
    # knocked-out flags present
    assert (arr[:, 4] == 0).any() and (arr[:, 4] == 1).any()


def test_determine_parameters_mesh(tmp_path, monkeypatch):
    """--mesh routes through the sharded chain tier (8 virtual devices)."""
    out = str(tmp_path / "d")
    run_example("simulate.py", ["model", "--n-obs", "30", "--out", out],
                monkeypatch)
    run_example("determine_parameters.py",
                ["posterior", out + "_sims.json", "--n-iters", "20",
                 "--n-particles", "64", "--chains", "2", "--mesh",
                 "--out", str(tmp_path / "m")], monkeypatch)
    post = str(tmp_path / "m") + "_posterior_1.json"
    assert len(open(post).read().strip().split("\n")) == 20
