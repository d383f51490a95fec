"""repro_torch stands alone: importing every module loads neither jax nor
any ``repro`` module, and its entry points default to the GPU and raise
where there is none instead of carrying on on the CPU."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

SRC = os.path.join(os.path.dirname(__file__), "..", "src")

_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(k for k in sys.modules
                if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": names, "leaked": leaked}))
"""


def test_port_imports_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=os.path.abspath(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=240,
                         check=True)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec["leaked"] == []
    for name in ("repro_torch.kernels.load_prop", "repro_torch.kernels.ops",
                 "repro_torch.core.proxies", "repro_torch.dse.engine",
                 "repro_torch.routing.tables"):
        assert name in rec["modules"]


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_evaluate_design_defaults_to_cuda_and_raises_without_it(no_gpu):
    from repro_torch.core import evaluate_design
    from repro_torch.topologies import make_design
    from repro_torch.traffic import make_traffic

    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_design(make_design("mesh", 16),
                        make_traffic("random_uniform", 16))


@pytest.mark.parametrize("entry", ["engine", "encode", "batch_from_numpy",
                                   "diameter"])
def test_batched_entry_points_raise_without_gpu(no_gpu, entry):
    import numpy as np
    from repro_torch.core.latency import routed_diameter_batch
    from repro_torch.dse import (DseEngine, ExperimentSpec, batch_from_numpy,
                                 encode_designs, expand_experiments)

    nh = np.tile(np.arange(4, dtype=np.int32)[None, :, None], (1, 1, 4))
    z = np.zeros((1, 4, 4), np.float32)
    calls = {
        "engine": lambda: DseEngine(),
        "encode": lambda: encode_designs(
            expand_experiments(ExperimentSpec()), validate=False),
        "batch_from_numpy": lambda: batch_from_numpy(
            nh, z, z[:, 0], z, z, max_hops=1),
        "diameter": lambda: routed_diameter_batch(nh),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_explicit_cpu_device_runs_on_the_host(no_gpu):
    from repro_torch.dse import DseEngine

    assert DseEngine(device="cpu").device == torch.device("cpu")
