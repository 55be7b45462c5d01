"""Nothing a cell runs loads JAX or the JAX package, and the reference
loads nothing of the program; the command refuses to run without a card
or without the program."""

import json
import os
import shutil
import subprocess
import sys

from benchmark.tests.tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "egopack_tpu"}


def _fresh(args, cwd=ROOT):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=600)


def test_a_cells_path_loads_no_jax():
    """A fresh interpreter runs a whole tiny run of each cell; the
    top-level names of every loaded module are compared whole."""
    for cell in ("mtl-step", "novel-oscc-step", "mtl-loop"):
        proc = _fresh(["-m", "benchmark.tests.tiny", cell])
        assert proc.returncode == 0, proc.stderr[-2000:]
        loaded = set(json.loads(proc.stdout.splitlines()[-1]))
        assert "egopack_torch" in loaded and "torch" in loaded
        assert not loaded & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import sys, json; import benchmark.reference.model, "
            "benchmark.reference.params; print(json.dumps(sorted("
            "{m.split('.')[0] for m in sys.modules})))")
    proc = _fresh(["-c", code])
    assert proc.returncode == 0, proc.stderr[-2000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert not loaded & (FORBIDDEN | {"egopack_torch"})


def test_the_check_compares_whole_top_level_names():
    sys.path.insert(0, str(ROOT / "benchmark"))
    try:
        import run
    finally:
        sys.path.pop(0)
    saved = dict(sys.modules)
    try:
        for name in ("egopack_t", "jaxtyping", "flaxen", "optaxx"):
            sys.modules[name] = sys
        assert run.forbidden_modules() == []
        sys.modules["jax.numpy"] = sys
        assert run.forbidden_modules() == ["jax"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_no_card_no_result():
    proc = _fresh(["benchmark/run.py", "--workload", "mtl-step", "--seed",
                   "2147483700", "--seconds", "1", "--trace", "0"])
    if proc.returncode == 0:  # a host with a card
        return
    assert proc.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    proc = _fresh(["benchmark/run.py", "--workload", "mtl-step", "--seed",
                   "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
