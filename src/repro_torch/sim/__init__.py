# Port of src/repro/sim/__init__.py: the same exports.
from .cyclesim import CycleSim, SimConfig, SimStats, sim_from_design
from .simfast import FastSim, fast_sim_from_design
from .saturation import (SaturationResult, saturation_throughput,
                         saturation_throughput_batched, zero_load_latency)

ENGINES = {"cycle": sim_from_design, "fast": fast_sim_from_design}


def make_sim(design, traffic, config=None, engine: str = "fast"):
    """Build a simulator for a design: ``engine='fast'`` (vectorized
    struct-of-arrays engine with numpy/C/torch backends, the default) or
    ``engine='cycle'`` (the slow per-flit reference oracle)."""
    try:
        factory = ENGINES[engine]
    except KeyError:
        raise ValueError(f"unknown sim engine {engine!r}; "
                         f"options: {sorted(ENGINES)}") from None
    return factory(design, traffic, config)


__all__ = ["CycleSim", "FastSim", "SimConfig", "SimStats", "sim_from_design",
           "fast_sim_from_design", "make_sim", "ENGINES", "SaturationResult",
           "saturation_throughput", "saturation_throughput_batched",
           "zero_load_latency"]
