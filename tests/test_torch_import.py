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
                 "repro_torch.routing.tables", "repro_torch.kernels.ref",
                 "repro_torch.kernels.minplus", "repro_torch.kernels.apsp",
                 "repro_torch.routing.device",
                 "repro_torch.routing.hierarchical",
                 "repro_torch.opt.space", "repro_torch.dse.genomes",
                 "repro_torch.kernels.flow_accum",
                 "repro_torch.kernels.selective_scan",
                 "repro_torch.configs", "repro_torch.configs.falcon_mamba_7b",
                 "repro_torch.models.config", "repro_torch.models.layers",
                 "repro_torch.models.ssm", "repro_torch.models.model",
                 "repro_torch.models.convert", "repro_torch.train.optimizer",
                 "repro_torch.train.step", "repro_torch.data.pipeline",
                 "repro_torch.launch.train", "repro_torch.models",
                 "repro_torch.train", "repro_torch.data",
                 "repro_torch.launch", "repro_torch.utils.version",
                 "repro_torch.faults", "repro_torch.faults.harness",
                 "repro_torch.faults.model", "repro_torch.faults.objectives",
                 "repro_torch.faults.reference", "repro_torch.obs.report",
                 "repro_torch.obs.__main__", "repro_torch.opt.operators",
                 "repro_torch.opt.archive", "repro_torch.opt.algorithms",
                 "repro_torch.opt.runner", "repro_torch.opt.__main__",
                 "repro_torch.dse.pareto", "repro_torch.serve",
                 "repro_torch.serve.job", "repro_torch.serve.service",
                 "repro_torch.serve.__main__", "repro_torch.sim",
                 "repro_torch.sim.cyclesim", "repro_torch.sim.simfast",
                 "repro_torch.sim._ckernel", "repro_torch.sim.saturation",
                 "repro_torch.sim.simfast_torch", "repro_torch.ckpt",
                 "repro_torch.ckpt.checkpoint", "repro_torch.analysis",
                 "repro_torch.analysis.findings", "repro_torch.analysis.lint",
                 "repro_torch.analysis.graph_audit",
                 "repro_torch.analysis.registry",
                 "repro_torch.analysis.__main__",
                 "repro_torch.core.visualize", "repro_torch.core.reference",
                 "repro_torch.traffic.trace", "repro_torch.models.moe",
                 "repro_torch.models.mla", "repro_torch.launch.serve"):
        assert name in rec["modules"]
    configs = [m for m in rec["modules"]
               if m.startswith("repro_torch.configs.")]
    assert len(configs) == 10


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
                                   "diameter", "lowest_id_tables",
                                   "hierarchical", "model",
                                   "population_evaluator", "opt_runner",
                                   "opt_cli", "search_service",
                                   "run_spec_solo", "serve_cli",
                                   "run_batch_torch", "fastsim_torch",
                                   "latency_vs_load_torch",
                                   "analysis_audit_cli", "launch_serve_cli",
                                   "serve_generate", "audit_contract",
                                   "audit_all", "engine_devices",
                                   "resolve_devices"])
def test_batched_entry_points_raise_without_gpu(no_gpu, entry, tmp_path):
    import numpy as np
    from repro_torch.core.latency import routed_diameter_batch
    from repro_torch.routing.device import next_hop_lowest_id_batch
    from repro_torch.routing.hierarchical import hops_next_hop_auto
    from repro_torch.dse import (DseEngine, ExperimentSpec, batch_from_numpy,
                                 encode_designs, expand_experiments)
    from repro_torch.configs import get_config
    from repro_torch.models import Model, reduced
    from repro_torch.opt import (AdjacencySpace, OptRunner,
                                 PopulationEvaluator)
    from repro_torch.opt.runner import main, make_optimizer
    from repro_torch.serve import JobSpec, SearchService, run_spec_solo
    from repro_torch.serve.__main__ import main as serve_main
    from repro_torch.sim import SimConfig, fast_sim_from_design
    from repro_torch.sim.simfast_torch import run_batch_torch
    from repro_torch.topologies import make_design
    from repro_torch.traffic import make_traffic
    from repro_torch.core.visualize import latency_vs_load
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.launch.serve import generate, main as launch_serve_main
    from repro_torch.analysis import audit_all, audit_contract
    from repro_torch.analysis.registry import contracts
    from repro_torch.utils.device import resolve_devices

    nh = np.tile(np.arange(4, dtype=np.int32)[None, :, None], (1, 1, 4))
    sim = fast_sim_from_design(make_design("mesh", 4),
                               make_traffic("random_uniform", 4),
                               SimConfig(warmup_cycles=10, measure_cycles=20,
                                         drain_cycles=20))
    z = np.zeros((1, 4, 4), np.float32)
    calls = {
        "engine": lambda: DseEngine(),
        "encode": lambda: encode_designs(
            expand_experiments(ExperimentSpec()), validate=False),
        "batch_from_numpy": lambda: batch_from_numpy(
            nh, z, z[:, 0], z, z, max_hops=1),
        "diameter": lambda: routed_diameter_batch(nh),
        "lowest_id_tables": lambda: next_hop_lowest_id_batch(
            np.where(np.eye(4) > 0, np.inf, 1.0)[None]),
        "hierarchical": lambda: hops_next_hop_auto(
            np.ones((4, 4), bool) & ~np.eye(4, dtype=bool), None),
        "model": lambda: Model(reduced(get_config("falcon-mamba-7b"))),
        "population_evaluator": lambda: PopulationEvaluator(
            AdjacencySpace(8, 3)),
        "opt_runner": lambda: OptRunner(make_optimizer(
            "nsga2", AdjacencySpace(8, 3),
            PopulationEvaluator(AdjacencySpace(8, 3)))).run(1),
        "opt_cli": lambda: main(["--n-chiplets", "8", "--generations", "1",
                                 "--pop-size", "4", "--quiet"]),
        "search_service": lambda: SearchService(),
        "run_spec_solo": lambda: run_spec_solo(
            JobSpec(job_id="a", generations=1, pop_size=4)),
        "serve_cli": lambda: serve_main(["--state-dir",
                                         str(tmp_path / "state")]),
        "run_batch_torch": lambda: run_batch_torch(sim, [0.1], sim.cfg),
        "fastsim_torch": lambda: sim.run_batch([0.1], backend="torch"),
        "latency_vs_load_torch": lambda: latency_vs_load(
            make_design("mesh", 4), make_traffic("random_uniform", 4),
            rates=(0.1,), config=sim.cfg, backend="torch"),
        "analysis_audit_cli": lambda: analysis_main(["--audit"]),
        "launch_serve_cli": lambda: launch_serve_main(
            ["--arch", "qwen2.5-3b", "--reduced"]),
        "serve_generate": lambda: generate(
            Model(reduced(get_config("hymba-1.5b"))),
            np.zeros((1, 4), np.int64), 2),
        "audit_contract": lambda: audit_contract(contracts()[0]),
        "audit_all": lambda: audit_all(list(contracts())),
        "engine_devices": lambda: DseEngine(devices=None),
        "resolve_devices": lambda: resolve_devices(None),
    }
    with pytest.raises(RuntimeError, match="CUDA"):
        calls[entry]()


def test_train_defaults_to_cuda_and_raises_without_it(no_gpu):
    from repro_torch.configs import get_config
    from repro_torch.launch.train import train
    from repro_torch.models import reduced

    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(reduced(get_config("falcon-mamba-7b")), steps=1, batch=1,
              seq_len=16)


def test_explicit_cpu_device_runs_on_the_host(no_gpu):
    from repro_torch.dse import DseEngine

    assert DseEngine(device="cpu").device == torch.device("cpu")


ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.mark.parametrize("script", ["chip_smoke.py", "tools/scan_bwd_steps.py",
                                    "tools/scan_fwd_steps.py",
                                    "tools/load_prop_steps.py",
                                    "tools/apsp_steps.py"])
def test_card_scripts_import_neither_jax_nor_repro(script):
    """The scripts that drive the port on the card (whose machine has no
    JAX) import nothing of jax or of the reference package, at any depth
    of their code."""
    import ast

    with open(os.path.join(ROOT, script)) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    roots = {name.split(".")[0] for name in names}
    assert "jax" not in roots and "repro" not in roots, sorted(roots)
    assert "repro_torch" in roots
