# Copy of src/repro/sim/cyclesim.py (sim_from_design uses the port's
# core.proxies.prepare_arrays).
"""BookSim2-lite: a synchronous, flit-level, input-queued VC cycle simulator.

This is the implemented stand-in for the paper's BookSim2 baseline
(DESIGN.md §2): wormhole flow control with virtual channels, credit-based
backpressure, one-flit-per-cycle links, table-based routing, and per-hop
delays taken from the same graph the proxies use (router processing =
vertex weight; link traversal = edge latency incl. PHYs). Defaults follow
the paper's §3.1 setup: 4 VCs x 16-flit buffers.

The router is modeled at the granularity the proxies' claims depend on:
buffer occupancy, link serialization, output contention, ejection bandwidth
— the phenomena that create the latency-vs-load curve and the saturation
point. The RC/VA/SA/ST pipeline is folded into the per-hop delay rather than
simulated stage-by-stage (it shifts zero-load latency by a constant the
proxy's own vertex weights already carry).

Pure Python/numpy and deliberately the *slow, trusted* baseline: the paper's
speedup claims are measured against this simulator.
"""
from __future__ import annotations

import collections
from dataclasses import dataclass, field

import numpy as np


@dataclass
class SimConfig:
    packet_size_flits: int = 4
    num_vcs: int = 4                  # paper §3.1
    buf_flits_per_vc: int = 16        # paper §3.1
    warmup_cycles: int = 1000
    measure_cycles: int = 3000
    drain_cycles: int = 3000
    deadlock_cycles: int = 2000       # no-progress watchdog
    seed: int = 0


@dataclass
class SimStats:
    avg_packet_latency: float
    avg_head_latency: float
    offered_flits_per_node: float
    accepted_flits_per_node: float
    packets_measured: int
    stable: bool
    deadlock: bool = False


class _Packet:
    __slots__ = ("src", "dst", "birth", "head_arrival")

    def __init__(self, src, dst, birth):
        self.src = src
        self.dst = dst
        self.birth = birth
        self.head_arrival = -1


class _Flit:
    __slots__ = ("pkt", "is_head", "is_tail", "ready")

    def __init__(self, pkt, is_head, is_tail, ready):
        self.pkt = pkt
        self.is_head = is_head
        self.is_tail = is_tail
        self.ready = ready


class CycleSim:
    """One network instance; ``run(injection_rate)`` returns SimStats.

    Ports per node: one input VC set per incoming link + one injection
    queue; one output per outgoing link + one ejection port.
    """

    def __init__(self, next_hop: np.ndarray, hop_delay: np.ndarray,
                 node_delay: np.ndarray, traffic_probs: np.ndarray,
                 config: SimConfig | None = None):
        self.cfg = config or SimConfig()
        self.next_hop = np.asarray(next_hop, np.int64)
        n = self.next_hop.shape[0]
        self.n = n
        # integer per-hop delays >= 1 (router processing + link traversal);
        # non-edges (inf) become a sentinel that must never be dereferenced
        hd = np.where(np.isfinite(hop_delay), np.rint(hop_delay), 1 << 30)
        self.hop_delay = np.maximum(hd.astype(np.int64), 1)
        self.node_delay = np.maximum(np.rint(node_delay).astype(np.int64), 0)
        self.neighbors = [np.nonzero(hop_delay[u] < np.inf)[0].tolist()
                          for u in range(n)]
        # traffic: per-source destination distribution
        tp = np.asarray(traffic_probs, np.float64).copy()
        np.fill_diagonal(tp, 0.0)
        self.src_rate = tp.sum(axis=1)
        total = self.src_rate.sum()
        if total <= 0:
            raise ValueError("empty traffic pattern")
        # normalize: relative injection share per source, dest distribution
        self.src_share = self.src_rate / self.src_rate.max()
        self.dest_dist = np.where(self.src_rate[:, None] > 0,
                                  tp / np.maximum(self.src_rate[:, None], 1e-30),
                                  0.0)

    # ------------------------------------------------------------------
    def run(self, injection_rate: float, config: SimConfig | None = None
            ) -> SimStats:
        cfg = config or self.cfg
        rng = np.random.default_rng(cfg.seed)
        n, V = self.n, cfg.num_vcs
        cap = cfg.buf_flits_per_vc
        psize = cfg.packet_size_flits

        # in_buf[v_node][src_node][vc] -> deque of flits (input-queued per link)
        in_buf = [collections.defaultdict(
            lambda: [collections.deque() for _ in range(V)]) for _ in range(n)]
        # credits mirror downstream buffer free space
        inj_q: list[collections.deque] = [collections.deque() for _ in range(n)]
        # wormhole state: (node, in_key, vc) currently owning (out_node, out_vc)
        vc_route: dict[tuple[int, object, int], tuple[int, int]] = {}
        # downstream VC occupancy bookkeeping for VC allocation
        vc_owner: dict[tuple[int, int, int], tuple] = {}

        offered = 0
        accepted = 0
        lat_sum = 0.0
        head_lat_sum = 0.0
        pkts_done = 0
        measured_done = 0
        last_progress = 0
        deadlock = False

        warm_end = cfg.warmup_cycles
        meas_end = warm_end + cfg.measure_cycles
        horizon = meas_end + cfg.drain_cycles
        flit_rate = injection_rate / psize
        rr_state: dict = {}

        cycle = 0
        while cycle < horizon:
            progressed = False
            # 1. injection: Bernoulli per node, scaled by its traffic share
            if cycle < meas_end:
                rand = rng.random(n)
                for u in range(n):
                    if self.src_share[u] <= 0:
                        continue
                    if rand[u] < flit_rate * self.src_share[u]:
                        d = int(rng.choice(self.n, p=self.dest_dist[u]))
                        pkt = _Packet(u, d, cycle)
                        for fi in range(psize):
                            inj_q[u].append(_Flit(
                                pkt, fi == 0, fi == psize - 1, cycle))
                        if warm_end <= cycle:
                            offered += psize

            # 2. per-node arbitration: each output link and the ejection port
            # accept at most one flit per cycle; inputs iterate round-robin.
            for u in range(n):
                # Collect candidate input VCs: (key, vc, deque)
                cands = []
                if inj_q[u]:
                    cands.append(("inj", 0, inj_q[u]))
                for src, vcs in in_buf[u].items():
                    for vc in range(V):
                        if vcs[vc]:
                            cands.append((src, vc, vcs[vc]))
                if not cands:
                    continue
                # round-robin offset per node
                off = rr_state.get(u, 0)
                cands = cands[off % len(cands):] + cands[:off % len(cands)]
                rr_state[u] = off + 1
                used_out: set[int] = set()   # output ports granted this cycle
                ejected_this_cycle = False
                for key, vc, q in cands:
                    flit = q[0]
                    if flit.ready > cycle:
                        continue
                    d = flit.pkt.dst
                    if d == u:
                        # ejection port: 1 flit/cycle
                        if ejected_this_cycle:
                            continue
                        q.popleft()
                        ejected_this_cycle = True
                        progressed = True
                        if flit.is_head:
                            flit.pkt.head_arrival = cycle + self.node_delay[u]
                        if flit.is_tail:
                            pkts_done += 1
                            if warm_end <= flit.pkt.birth < meas_end:
                                lat = cycle + self.node_delay[u] - flit.pkt.birth
                                lat_sum += lat
                                head_lat_sum += (flit.pkt.head_arrival
                                                 - flit.pkt.birth)
                                measured_done += 1
                                accepted += psize
                        continue
                    v = int(self.next_hop[u, d])
                    if v == u:
                        raise RuntimeError(f"no route {u}->{d}")
                    if v in used_out:
                        continue
                    state_key = (u, key, vc)
                    route = vc_route.get(state_key)
                    if route is None:
                        if not flit.is_head:
                            continue   # lost arbitration mid-packet? impossible
                        # VC allocation on downstream input (v, from u)
                        out_vc = None
                        down = in_buf[v][u]
                        for cand_vc in range(V):
                            owner = vc_owner.get((v, u, cand_vc))
                            if owner is None and len(down[cand_vc]) < cap:
                                out_vc = cand_vc
                                break
                        if out_vc is None:
                            continue
                        vc_owner[(v, u, out_vc)] = state_key
                        vc_route[state_key] = (v, out_vc)
                        route = (v, out_vc)
                    v, out_vc = route
                    down = in_buf[v][u]
                    if len(down[out_vc]) >= cap:
                        continue   # no credit
                    q.popleft()
                    used_out.add(v)
                    progressed = True
                    delay = self.node_delay[u] + self.hop_delay[u, v]
                    down[out_vc].append(_Flit(flit.pkt, flit.is_head,
                                              flit.is_tail, cycle + delay))
                    if flit.is_tail:
                        del vc_route[state_key]
                        del vc_owner[(v, u, out_vc)]

            if progressed:
                last_progress = cycle
            elif (cycle - last_progress > cfg.deadlock_cycles
                  and (any(inj_q) or self._any_buf(in_buf))):
                deadlock = True
                break
            cycle += 1
            # early exit once drained
            if cycle > meas_end and not self._any_buf(in_buf) and \
                    not any(inj_q):
                break

        meas_window = cfg.measure_cycles
        acc_rate = accepted / (n * meas_window)
        off_rate = offered / (n * meas_window)
        avg_lat = lat_sum / measured_done if measured_done else float("inf")
        avg_head = head_lat_sum / measured_done if measured_done else float("inf")
        stable = (not deadlock and measured_done > 0 and
                  acc_rate >= 0.95 * off_rate)
        return SimStats(avg_packet_latency=avg_lat, avg_head_latency=avg_head,
                        offered_flits_per_node=off_rate,
                        accepted_flits_per_node=acc_rate,
                        packets_measured=measured_done, stable=stable,
                        deadlock=deadlock)

    @staticmethod
    def _any_buf(in_buf) -> bool:
        for node in in_buf:
            for _, vcs in node.items():
                for q in vcs:
                    if q:
                        return True
        return False


def sim_from_design(design, traffic: np.ndarray,
                    config: SimConfig | None = None,
                    cls: type | None = None) -> CycleSim:
    """Build a simulator from a Design + traffic matrix, using the same
    prepared arrays (graph + routing table) as the proxies — so the
    comparison isolates *proxy approximation error*, not input differences.
    ``cls`` picks the engine class (CycleSim default; FastSim via
    ``fast_sim_from_design``) so both engines see identical inputs."""
    from ..core.proxies import prepare_arrays

    arrays, g = prepare_arrays(design)
    n = g.n
    tp = np.zeros((n, n), np.float64)
    tp[:traffic.shape[0], :traffic.shape[1]] = traffic
    return (cls or CycleSim)(
        next_hop=arrays.next_hop,
        hop_delay=np.where(np.isfinite(g.adj_lat), g.adj_lat, np.inf),
        node_delay=g.node_weight,
        traffic_probs=tp, config=config)
