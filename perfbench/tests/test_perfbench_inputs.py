"""The inputs made from the seed, and the frozen repairs against the
port's."""
import numpy as np
import pytest

import repro_torch.core  # noqa: F401
from repro_torch.opt import AdjacencySpace

from perfbench.gen.traffic import FaultGridMix
from perfbench.reference import repair as ref_repair

MIX = {"population": 6, "scenarios": 5, "link_fail_p": 0.05,
       "parent_pool": 6, "crossover_prob": 0.9, "mutation_rate": None}


@pytest.mark.parametrize("seed", [0, 2**31 + 12345, 2**40 + 7])
def test_offspring_and_scenarios_repeat_for_one_seed(seed):
    a, b = FaultGridMix(MIX, 16, 4, seed), FaultGridMix(MIX, 16, 4, seed)
    assert np.array_equal(a.pool, b.pool)
    assert np.array_equal(a.link_fail, b.link_fail)
    assert np.array_equal(a.node_fail, b.node_fail)
    for i in (0, 3, 1000):
        assert np.array_equal(a.offspring(i), b.offspring(i))
    assert not np.array_equal(a.offspring(0), a.offspring(1))
    assert not a.link_fail[0].any() and a.link_fail[1:].any()
    assert a.link_fail.shape == (MIX["scenarios"], 120)
    c = FaultGridMix(MIX, 16, 4, seed + 1)
    assert not np.array_equal(a.offspring(0), c.offspring(0))


def test_mutation_rate_is_nsga2_default():
    mix = FaultGridMix(MIX, 64, 8, 1)
    assert mix.mutation_rate == max(1 / 2016, 0.01)
    assert mix.crossover_prob == 0.9


@pytest.mark.parametrize("n, degree", [(16, 3), (64, 8)])
def test_frozen_repairs_equal_the_ports(n, degree):
    mix = FaultGridMix({**MIX, "population": 12, "parent_pool": 12}, n,
                       degree, 77)
    space = AdjacencySpace(n_chiplets=n, max_degree=degree)
    rng = np.random.default_rng(3)
    raw = np.concatenate([mix.offspring(0), mix.offspring(1),
                          (rng.random((8, space.genome_length)) < 0.2)
                          .astype(np.int64),
                          np.zeros((2, space.genome_length), np.int64)])
    want = space.repair(raw)
    assert np.array_equal(ref_repair.repair(raw, n, degree), want)
    assert np.array_equal(mix.pool, space.repair(mix.pool))
