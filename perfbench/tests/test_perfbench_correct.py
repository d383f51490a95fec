"""The comparison that decides ``correct``: the reference agrees with the
port's CPU path, and the control and each planted fault of the timed path
come out not correct."""
import time

import numpy as np
import pytest
from conftest import TINY

import repro_torch.core  # noqa: F401
from repro_torch.dse import DseEngine
from repro_torch.opt import AdjacencySpace

from perfbench import calibrate, compare, harness
from perfbench.gen.traffic import FaultGridMix
from perfbench.reference import grid

MIX = {"population": 8, "scenarios": 5, "link_fail_p": 0.1,
       "parent_pool": 8, "crossover_prob": 0.9, "mutation_rate": None}


@pytest.mark.parametrize("n, degree", [(16, 3), (16, 8), (25, 4)])
def test_reference_agrees_with_the_ports_cpu_path(n, degree):
    mix = FaultGridMix(MIX, n, degree, 2024)
    space = AdjacencySpace(n_chiplets=n, max_degree=degree)
    engine = DseEngine(device="cpu")
    for call in (0, 1):
        raw = mix.offspring(call)
        rep = space.repair(raw)
        got = engine.evaluate_genomes_faults_async(
            space, rep, mix.link_fail, mix.node_fail).result()
        ref = grid.evaluate(raw, mix.link_fail, mix.node_fail, n, degree)
        g = compare.gaps(rep, got, ref)
        assert g["repair_bits"] == 0 and g["routed_diff"] == 0
        assert g["latency_rel"] < 1e-6 and g["throughput_rel"] < 1e-6
        assert g["reach_abs"] < 1e-6 and g["report_rel"] < 1e-12
        assert (ref.reachable_fraction < 1).any()      # faults bite


def _run(root, program=None, seed=11):
    return harness.run(root, TINY, seed, 1.0, False, time.perf_counter(),
                       device="cpu", program=program)


def test_sound_run_is_correct(tiny_root):
    result = _run(tiny_root)
    assert result["correct"]
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())


def test_control_is_not_correct(tiny_root):
    result = _run(tiny_root, calibrate.control_program(16, 4, "cpu"))
    assert not result["correct"]
    c = result["checks"]
    assert c["latency_rel"]["value"] > c["latency_rel"]["limit"]
    assert c["throughput_rel"]["value"] > c["throughput_rel"]["limit"]


class _Altered:
    def __init__(self, handle, alter):
        self._handle, self._alter = handle, alter

    def result(self):
        res = self._handle.result()
        self._alter(res)
        return res


def _evaluate_with(alter):
    def make(engine):
        def evaluate(space, genomes, link_fail, node_fail):
            return _Altered(engine.evaluate_genomes_faults_async(
                space, genomes, link_fail, node_fail), alter)
        return evaluate
    return {"evaluate": make}


def _one_answer(res):
    res.latency[3, 2] *= 1.0 + 1e-3


def _one_throughput(res):
    res.throughput[5, 1] *= 1.0 - 1e-3


def _one_reach(res):
    res.reachable_fraction[1, 3] -= 1e-3


def _half_left_out(res):
    half = len(res.latency) // 2
    for x in (res.latency, res.throughput, res.reachable_fraction):
        x[half:] = x[:half].mean(axis=0)


def _half_evaluated():
    """Half of the population evaluated, the rest given their mean."""
    def make(engine):
        def evaluate(space, genomes, link_fail, node_fail):
            half = len(genomes) // 2
            return _Altered(engine.evaluate_genomes_faults_async(
                space, np.concatenate([genomes[:half]] * 2), link_fail,
                node_fail), _half_left_out)
        return evaluate
    return {"evaluate": make}


def _repair_drops_a_link():
    def make(space):
        def repair(raw):
            rep = space.repair(raw).copy()
            g = np.nonzero(rep[0])[0][-1]
            rep[0, g] = 0
            return rep
        return repair
    return {"repair": make}


@pytest.mark.parametrize("fault, caught_by", [
    (_evaluate_with(_one_answer), "latency_rel"),
    (_evaluate_with(_one_throughput), "throughput_rel"),
    (_evaluate_with(_one_reach), "reach_abs"),
    (_half_evaluated(), "latency_rel"),
    (_repair_drops_a_link(), "repair_bits"),
], ids=["answer-altered", "throughput-altered", "reach-altered",
        "half-left-out", "repair-drops-link"])
def test_planted_fault_is_not_correct(tiny_root, fault, caught_by):
    result = _run(tiny_root, fault)
    assert not result["correct"]
    c = result["checks"][caught_by]
    assert c["value"] > c["limit"]
