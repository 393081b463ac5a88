"""``run.py`` and the import guard: without a card a run prints no result
and fails; a directory holding only the benchmark fails; a driver's run
loads neither JAX nor the JAX package (top-level names compared whole)."""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest

from twinbench.harness import files, guard

RUN = files.ROOT / "run.py"


def _env(**extra):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", **extra)
    env.pop("PYTHONPATH", None)
    return env


def test_guard_compares_whole_top_level_names():
    assert guard.forbidden_modules(["repro_torch.core", "reprox", "jaxtyping"]) == []
    assert guard.forbidden_modules(["repro.core.twin", "jax.numpy", "flax", "os"]) == [
        "flax", "jax", "repro"]


def test_run_without_a_card_fails_and_prints_no_result():
    out = subprocess.run([sys.executable, str(RUN), "--workload", "lisa-whatif-64", "--seed",
                          str(2**31 + 5), "--seconds", "1", "--trace", "0"],
                         cwd=files.CHECKOUT, capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode == 3, out.stderr
    assert out.stdout.strip() == ""
    assert "needs 1 CUDA device" in out.stderr


def test_run_in_a_directory_of_the_benchmark_alone_fails(tmp_path):
    shutil.copy(files.CHECKOUT / "BENCHMARK.json", tmp_path)
    shutil.copytree(files.ROOT, tmp_path / "twinbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "twinbench/run.py", "--workload", "lisa-e2-replay",
                          "--seed", "3", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120, env=_env())
    assert out.returncode != 0
    assert not out.stdout.strip().startswith("{")


@pytest.mark.parametrize("driver,make", [("whatif", "whatif_cell"), ("replay", "replay_cell")])
def test_a_drivers_run_loads_no_jax_in_a_fresh_process(driver, make):
    code = (
        "import sys, torch\n"
        f"sys.path[:0] = [{str(files.CHECKOUT)!r}, {str(files.CHECKOUT / 'src')!r}]\n"
        f"from twinbench.drivers import {driver} as d\n"
        "from twinbench.harness import guard\n"
        "from twinbench.tests import tiny\n"
        f"out = d.run(tiny.{make}(), seed=11, seconds=0.2, traced=False,"
        " device=torch.device('cpu'), t_start=0.0)\n"
        "print(guard.forbidden_modules(), out.attempted > 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=_env(USE_FLAX="0"))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in files.manifest()["workloads"]])
def test_a_short_run_on_the_card_is_correct(card, cell):
    out = subprocess.run([sys.executable, str(RUN), "--workload", cell, "--seed",
                          str(2**31 + 77), "--seconds", "2", "--trace", "0"],
                         cwd=files.CHECKOUT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
