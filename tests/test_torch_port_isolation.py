"""The port stands alone: no module of ``egopack_torch``, and not
``chip_smoke.py``, imports JAX or ``egopack_tpu``, and its entry points
raise instead of dropping to the CPU.

The import check runs in a fresh interpreter: this process has JAX loaded
already (``tests/conftest.py``)."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import egopack_torch
from egopack_torch import device as tdevice
from egopack_torch import entry

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(["egopack_torch"] + [
    m.name for m in pkgutil.walk_packages(egopack_torch.__path__,
                                          "egopack_torch.")]) + ["chip_smoke"]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "egopack_tpu", "yaml",
             "msgpack")

_PROBE = """
import importlib, json, sys
out = {}
for name in sys.argv[1:]:
    importlib.import_module(name)
    out[name] = sorted(m for m in sys.modules
                       if m.split('.')[0] in %r)
print(json.dumps(out))
""" % (FORBIDDEN,)


@pytest.fixture(scope="module")
def imported():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _PROBE, *MODULES], cwd=REPO,
                          env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_imports_no_jax(imported, module):
    assert imported[module] == [], (module, imported[module])


PARALLEL = ["egopack_torch.parallel", "egopack_torch.parallel.collectives",
            "egopack_torch.parallel.dryrun", "egopack_torch.parallel.launch",
            "egopack_torch.parallel.mesh", "egopack_torch.parallel.multihost"]
TOOLS = ["egopack_torch.predict", "egopack_torch.sweep",
         "egopack_torch.aggregate", "egopack_torch.utils.plots",
         "egopack_torch.ops.criterion"] + PARALLEL


def test_parallel_modules_are_checked():
    """Every module of ``egopack_torch/parallel`` is among the modules
    imported above, and each is imported alone below."""
    found = [m for m in MODULES if m.startswith("egopack_torch.parallel")]
    assert found == PARALLEL


@pytest.fixture(scope="module")
def alone():
    """One interpreter for each tool, all started at once."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = {m: subprocess.Popen([sys.executable, "-c", _PROBE, m], cwd=REPO,
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for m in TOOLS}
    yield procs
    for proc in procs.values():
        proc.kill()
        proc.wait()


@pytest.mark.parametrize("module", TOOLS)
def test_tool_imports_no_jax_alone(alone, module):
    """Each tool in an interpreter of its own: nothing imported before it
    hides what it imports."""
    out, err = alone[module].communicate(timeout=300)
    assert alone[module].returncode == 0, err
    assert json.loads(out.strip().splitlines()[-1]) == {module: []}


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.build_system(8, 8, 4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.build_mtl_step(2, 4, 8)
    assert entry.build_system(8, 8, 4, device="cpu").device.type == "cpu"



def test_phase2_entry_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.build_egopack_step(2, 4, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.build_system(8, 8, 4, phase2=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.random_banks(128, 100, 8)
    step = entry.build_egopack_step(2, 4, 8, p_pad=128, fill=100,
                                    device="cpu")
    assert step.system.device.type == "cpu"
    assert all(b.values.device.type == "cpu" for b in step.banks.values())
