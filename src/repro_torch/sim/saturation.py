# Copy of src/repro/sim/saturation.py, with backend='torch' on an explicit
# device; backend='torch' with workers > 1 raises (fork after CUDA).
"""Zero-load latency and saturation-throughput searches (paper §3.1).

The saturation search follows the paper's schedule exactly: coarse 10%
injection-rate steps until instability, then back off and refine with 1%
steps, then 0.1% steps. "Determining a saturation throughput of 12.3%
requires 9 simulations with the injection rates 10%, 20%, 11%, 12%, 13%,
12.1%, 12.2%, 12.3%, 12.4%" — those 9 are the *probes*; the zero-load run
that calibrates the latency cap is accounted separately so the speedup
bookkeeping matches the paper's.

Both searches are engine-agnostic: any object with the ``CycleSim`` run API
(``run(rate, cfg) -> SimStats`` plus a ``cfg`` attribute) works, so the
same search runs on the slow trusted oracle and on the vectorized
``FastSim``.
"""
from __future__ import annotations

from typing import NamedTuple

from ..faults.harness import call_with_retry
from ..obs.log import get_logger
from ..obs.trace import span as _span
from ..utils import env as _env
from .cyclesim import CycleSim, SimConfig, SimStats

_LOG = get_logger("sim")


def _probe_call(fn, *args, describe: str = "sim probe", **kwargs):
    """Run one simulator probe under the optional watchdog + bounded-retry
    harness (``REPRO_SIM_WATCHDOG_S`` / ``REPRO_SIM_RETRIES``): a probe
    that hangs past the deadline or raises is retried with backoff instead
    of wedging or crashing the whole saturation search."""
    timeout = _env.get_int("REPRO_SIM_WATCHDOG_S")
    return call_with_retry(fn, *args,
                           retries=_env.get_int("REPRO_SIM_RETRIES"),
                           timeout_s=timeout if timeout > 0 else None,
                           describe=describe, **kwargs)


class SaturationResult(NamedTuple):
    """Saturation rate plus the simulation-count breakdown."""
    rate: float           # saturation injection rate (flits/cycle/node)
    probes: int           # injection-rate probes (the paper's "9 simulations")
    zero_load_runs: int   # latency-cap calibration runs (1, or 0 when an
                          # explicit latency_cap was supplied)

    @property
    def total_sims(self) -> int:
        return self.probes + self.zero_load_runs


def zero_load_latency(sim: CycleSim, config: SimConfig | None = None,
                      rate: float = 0.005) -> SimStats:
    """Average packet latency at (near-)zero load: a single low-rate run
    (paper §3.1: 'a single BookSim-simulation is sufficient')."""
    cfg = config or sim.cfg
    return _probe_call(sim.run, rate, cfg, describe="zero-load run")


def _stable(sim: CycleSim, rate: float, cfg: SimConfig,
            latency_cap: float) -> bool:
    st = _probe_call(sim.run, rate, cfg,
                     describe=f"saturation probe rate={rate:.3f}")
    return st.stable and st.avg_packet_latency <= latency_cap


def saturation_throughput(sim: CycleSim, config: SimConfig | None = None,
                          latency_cap_factor: float = 4.0,
                          max_rate: float = 1.0,
                          latency_cap: float | None = None,
                          progress: bool = False) -> SaturationResult:
    """Find the saturation injection rate (flits/cycle/node fraction).

    Returns a ``SaturationResult``: the rate, the number of injection-rate
    probes, and the zero-load calibration run counted separately — the
    probe count feeds the speedup comparison, since the paper attributes
    the throughput proxy's larger speedup to the many near-saturation
    simulations, and its example counts only the probes.

    ``progress`` reports each probe of the search, in the same style as
    ``DseEngine.run(progress=True)``. An explicit ``latency_cap`` (cycles)
    skips the zero-load calibration run and uses the given cap — useful
    for comparing engines under identical acceptance thresholds.
    """
    cfg = config or sim.cfg
    zero_load_runs = 0
    if latency_cap is None:
        with _span("sat.zero_load"):
            zl = zero_load_latency(sim, cfg)
        latency_cap = latency_cap_factor * zl.avg_packet_latency
        zero_load_runs = 1
    probes = 0

    def ok(rate: float) -> bool:
        nonlocal probes
        probes += 1
        _LOG.log("info" if progress else "debug",
                 f"[sat] probe {probes}, rate={rate:.3f}")
        with _span("sat.probe", rate=round(rate, 4)):
            return _stable(sim, rate, cfg, latency_cap)

    # 10% steps
    last_good = 0.0
    rate = 0.1
    with _span("sat.ladder", step=0.1):
        while rate <= max_rate + 1e-9 and ok(rate):
            last_good = rate
            rate += 0.1
    # 1% steps from the last stable rate
    rate = last_good + 0.01
    with _span("sat.ladder", step=0.01):
        while rate <= max_rate + 1e-9 and ok(rate):
            last_good = rate
            rate += 0.01
    # 0.1% steps
    rate = last_good + 0.001
    with _span("sat.ladder", step=0.001):
        while rate <= max_rate + 1e-9 and ok(rate):
            last_good = rate
            rate += 0.001
    return SaturationResult(rate=last_good, probes=probes,
                            zero_load_runs=zero_load_runs)


def _run_batch_worker(args):
    sim, rates, cfg, backend = args
    return sim.run_batch(rates, cfg, backend=backend)


def _run_chunk(sim, rates, cfg, backend, pool, workers, device=None):
    """Run one speculative chunk, optionally sharded over worker processes.
    Sharding never changes results: every replica is seeded like a solo
    run, so grouping is irrelevant to the outcome."""
    if pool is None or len(rates) < 2:
        return _probe_call(sim.run_batch, rates, cfg, backend=backend,
                           device=device,
                           describe=f"batched probe x{len(rates)}")
    shard = (len(rates) + workers - 1) // workers
    jobs = [(sim, rates[i:i + shard], cfg, backend)
            for i in range(0, len(rates), shard)]
    out = []
    for part in _probe_call(pool.map, _run_batch_worker, jobs,
                            describe=f"pooled probe x{len(rates)}"):
        out.extend(part)
    return out


def saturation_throughput_batched(sim, config: SimConfig | None = None,
                                  latency_cap_factor: float = 4.0,
                                  max_rate: float = 1.0,
                                  chunk: int = 5,
                                  backend: str = "auto",
                                  workers: int = 1,
                                  latency_cap: float | None = None,
                                  progress: bool = False,
                                  device=None) -> SaturationResult:
    """``saturation_throughput`` with speculative, vectorized probing.

    Requires an engine with ``run_batch`` (FastSim). Each refinement ladder
    (10% / 1% / 0.1% steps) is evaluated ``chunk`` rungs at a time in one
    ``run_batch`` call; because every replica is seeded exactly like a solo
    run, the returned rate is identical to the sequential search's, and
    ``probes`` still counts the probes the paper's sequential schedule
    would have run (speculatively evaluated rungs past the first failure
    are not probes, they are wasted parallel work the batching amortizes).
    ``backend`` selects the FastSim execution backend — ``'auto'``
    (default: the C kernel when a compiler is available, else numpy),
    ``'c'``, ``'numpy'``, or ``'torch'`` (on ``device``: the card unless
    the caller passes ``device="cpu"``); ``workers > 1`` shards each
    chunk's rungs over forked processes (identical results — grouping
    does not affect per-replica outcomes). A forked child of a process
    that has initialised CUDA cannot use it, so ``backend='torch'`` with
    ``workers > 1`` raises.
    """
    cfg = config or sim.cfg
    if backend == "torch" and workers > 1:
        raise ValueError("backend='torch' runs in this process: workers > 1 "
                         "forks, and a forked child cannot use CUDA")
    pool = None
    if workers > 1:
        import multiprocessing as mp
        pool = mp.get_context("fork").Pool(workers)
    try:
        return _saturation_batched(sim, cfg, latency_cap_factor, max_rate,
                                   chunk, backend, pool, workers,
                                   latency_cap, progress, device)
    finally:
        if pool is not None:
            pool.close()


def _saturation_batched(sim, cfg, latency_cap_factor, max_rate, chunk,
                        backend, pool, workers, latency_cap,
                        progress, device=None) -> SaturationResult:
    zero_load_runs = 0
    if latency_cap is None:
        with _span("sat.zero_load"):
            zl = _probe_call(sim.run_batch, [0.005], cfg, backend=backend,
                             device=device, describe="zero-load run")[0]
        latency_cap = latency_cap_factor * zl.avg_packet_latency
        zero_load_runs = 1
    probes = 0
    last_good = 0.0
    for step in (0.1, 0.01, 0.001):
        # the exact float sequence the sequential loops visit (repeated
        # ``rate += step`` accumulation — one-ulp rate differences would
        # change the injection schedule and so the measured result)
        ladder = []
        rate = last_good + step
        while rate <= max_rate + 1e-9:
            ladder.append(rate)
            rate += step
        rung = 0
        failed = False
        while rung < len(ladder) and not failed:
            rates = ladder[rung:rung + chunk]
            _LOG.log("info" if progress else "debug",
                     f"[sat] probing rates "
                     f"{', '.join(f'{r:.3f}' for r in rates)}")
            with _span("sat.probe", step=step, rates=len(rates)):
                stats = _run_chunk(sim, rates, cfg, backend, pool, workers,
                                   device)
            for r, st in zip(rates, stats):
                probes += 1
                if st.stable and st.avg_packet_latency <= latency_cap:
                    last_good = r
                else:
                    failed = True
                    break
            rung += len(rates)
    return SaturationResult(rate=last_good, probes=probes,
                            zero_load_runs=zero_load_runs)
