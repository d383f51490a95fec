# Copy of src/repro/sim/simfast.py with backend='torch' (simfast_torch.py)
# in place of the reference's 'jax'.
"""Vectorized struct-of-arrays cycle simulator: the *fast* trusted baseline.

Same network model as ``CycleSim`` (wormhole flow control, virtual channels,
credit backpressure, 1 flit/cycle links, table routing, per-hop delays from
the proxy graph) but organized for whole-network array passes instead of a
Python object loop:

- Flits live in preallocated numpy ring buffers, one ring per
  (directed link, VC); a flit is a row of parallel arrays (packet id, flit
  sequence number, ready time), never an object.
- The injection process is *precomputed*: Bernoulli injection is independent
  of network state (queues are unbounded), so the full packet schedule
  (src, dst, birth) is drawn up front and each node's injection queue is a
  pointer into its birth-sorted packet slice.
- Each cycle runs a fixed set of array passes: gather ready head flits,
  eject (one winner per node), arbitrate output links (one winner per link,
  rotating hashed priority), allocate downstream VCs for winning head flits,
  then apply all pops/pushes at once.
- Idle spans are skipped: when no head flit is ready, the clock jumps to the
  next ready time / packet birth (bounded by the deadlock watchdog window so
  watchdog semantics match ``CycleSim``).
- ``run_batch`` amortizes numpy dispatch overhead across B *independent*
  simulations (e.g. the rungs of a saturation-search refinement ladder) by
  simulating B disjoint replicas of the network as one block-diagonal
  network; each replica draws its injection schedule from a fresh
  ``default_rng(seed)`` so ``run_batch([r])[0]`` and per-rate solo runs are
  bit-identical.

Decisions use start-of-cycle occupancy (credits freed by a pop become usable
next cycle), whereas ``CycleSim`` resolves nodes sequentially within a cycle;
together with a different RNG consumption order this makes the two engines
statistically — not bit-for-bit — equivalent. On deterministic single-flow
runs (one src/dst pair at zero load) both engines are *exact*: latency is
sum(node_delay[u] + hop_delay[u, v]) over the path + node_delay[dst]
+ (packet_size_flits - 1). Equivalence is asserted in tests/test_torch_sim.py.
"""
from __future__ import annotations

import numpy as np

from .cyclesim import CycleSim, SimConfig, SimStats

_SENTINEL = 1 << 30    # CycleSim's non-edge hop-delay marker
_FAR = np.int64(1) << np.int64(60)   # "never ready" timestamp
_FAR32 = np.int32(1) << np.int32(30)  # int32 variant used by run_batch

# Knuth-style multiplicative hash for the rotating arbitration priority:
# cheap, deterministic, and decorrelated across cycles.
_HASH_A = np.int64(2654435761)
_HASH_B = np.int64(40503)
_PRIO_MASK = np.int64(0x7FFFFFFF)


_IOTA = np.arange(1 << 14, dtype=np.int64)


def _winners(group: np.ndarray, prio: np.ndarray) -> np.ndarray:
    """Indices (into ``group``) of the min-priority element of each group.
    Ties break toward the lower index, matching a stable sort."""
    group = group.astype(np.int64, copy=False)
    if group.size < (1 << 14):
        # pack (group, prio, idx) into one int64 and use a plain C sort —
        # much faster than argsort's indirection for the common sizes
        keys = ((group << np.int64(45)) | (prio << np.int64(14))
                | _IOTA[:group.size])
        keys.sort()
        g = keys >> np.int64(45)
        keep = np.empty(g.size, bool)
        keep[0] = True
        keep[1:] = g[1:] != g[:-1]
        return keys[keep] & np.int64(0x3FFF)
    order = np.argsort((group << np.int64(31)) | prio, kind="stable")
    g = group[order]
    keep = np.empty(g.size, bool)
    keep[0] = True
    keep[1:] = g[1:] != g[:-1]
    return order[keep]


def assemble_stats(bn, cfg, offered, lat_sum, head_lat_sum, measured,
                   accepted, deadlock) -> list[SimStats]:
    """Per-replica SimStats from the accumulator arrays — the single
    implementation of the stats/stability rules shared by every run_batch
    backend (numpy, C, torch)."""
    meas_window = cfg.measure_cycles
    out = []
    for b in range(len(offered)):
        md = int(measured[b])
        acc_rate = accepted[b] / (bn * meas_window)
        off_rate = offered[b] / (bn * meas_window)
        avg = lat_sum[b] / md if md else float("inf")
        avg_h = head_lat_sum[b] / md if md else float("inf")
        stable = (not deadlock[b] and md > 0 and
                  acc_rate >= 0.95 * off_rate)
        out.append(SimStats(
            avg_packet_latency=float(avg), avg_head_latency=float(avg_h),
            offered_flits_per_node=float(off_rate),
            accepted_flits_per_node=float(acc_rate),
            packets_measured=md, stable=bool(stable),
            deadlock=bool(deadlock[b])))
    return out


class FastSim(CycleSim):
    """Drop-in fast engine: same constructor and ``run`` API as CycleSim,
    plus ``run_batch`` for running several injection rates at once."""

    def __init__(self, next_hop: np.ndarray, hop_delay: np.ndarray,
                 node_delay: np.ndarray, traffic_probs: np.ndarray,
                 config: SimConfig | None = None):
        super().__init__(next_hop, hop_delay, node_delay, traffic_probs,
                         config)
        n = self.n
        finite = np.isfinite(np.asarray(hop_delay, np.float64))
        np.fill_diagonal(finite, False)
        src, dst = np.nonzero(finite)
        self.link_src = src.astype(np.int64)
        self.link_dst = dst.astype(np.int64)
        self.n_links = len(src)
        self.link_id = np.full((n, n), -1, np.int64)
        self.link_id[src, dst] = np.arange(self.n_links)
        # delay added when a flit is forwarded along link l from its source
        self.link_fwd_delay = (self.node_delay[src]
                               + self.hop_delay[src, dst]).astype(np.int64)
        # (node, dest) -> outgoing link of the routed next hop; -1 where the
        # table has no usable hop (raised only if a packet ever needs it)
        self.out_link = self.link_id[np.arange(n)[:, None], self.next_hop]
        # per-source destination CDF for inverse-transform sampling; rows are
        # re-normalized so the final entry is exactly 1.0 (x/x == 1.0 in
        # IEEE), keeping searchsorted in range for any u in [0, 1).
        cdf = np.cumsum(self.dest_dist, axis=1)
        tail = cdf[:, -1:]
        self.dest_cdf = np.where(tail > 0, cdf / np.maximum(tail, 1e-300),
                                 cdf)
        self._rep_cache: dict[int, "FastSim"] = {}

    # ------------------------------------------------------------------
    def _draw_injections(self, rng, flit_rate: float, meas_end: int):
        """Precompute the full packet schedule: (src, dst, birth) arrays in
        CSR layout grouped by source node, birth-sorted within each node."""
        n = self.n
        p = np.minimum(flit_rate * self.src_share, 1.0)
        events = rng.random((meas_end, n)) < p[None, :]
        ev_cycle, ev_src = np.nonzero(events)
        order = np.argsort(ev_src, kind="stable")   # per-node, birth-sorted
        pk_src = ev_src[order].astype(np.int64)
        pk_birth = ev_cycle[order].astype(np.int64)
        k = len(pk_src)
        pk_dst = np.empty(k, np.int64)
        u = rng.random(k)
        for s in np.unique(pk_src):
            m = pk_src == s
            pk_dst[m] = np.searchsorted(self.dest_cdf[s], u[m], side="right")
        np.clip(pk_dst, 0, n - 1, out=pk_dst)
        counts = np.bincount(pk_src, minlength=n)
        offsets = np.concatenate(([0], np.cumsum(counts))).astype(np.int64)
        return pk_src, pk_dst, pk_birth, offsets

    def _prep_schedules(self, rates, cfg):
        """Per-replica injection schedules, each seeded exactly like a solo
        run — the single source of truth for every run_batch backend (the
        backends' bit-identity depends on them sharing this)."""
        psize = cfg.packet_size_flits
        meas_end = cfg.warmup_cycles + cfg.measure_cycles
        bn = self.n
        parts = []
        offset_parts = [np.zeros(1, np.int64)]
        offered = np.zeros(len(rates), np.int64)
        total = 0
        for b, r in enumerate(rates):
            rng = np.random.default_rng(cfg.seed)
            ps, pd, pb, off = self._draw_injections(rng, r / psize, meas_end)
            parts.append((pd + b * bn, pb))
            offset_parts.append(off[1:] + total)
            total += len(ps)
            offered[b] = psize * int(
                np.count_nonzero(pb >= cfg.warmup_cycles))
        if total:
            pk_dst = np.concatenate([p[0] for p in parts])
            pk_birth = np.concatenate([p[1] for p in parts])
        else:
            pk_dst = np.zeros(0, np.int64)
            pk_birth = np.zeros(0, np.int64)
        offsets = np.concatenate(offset_parts)
        return pk_dst, pk_birth, offsets, offered, total


    # ------------------------------------------------------------------
    def _replicated(self, B: int) -> "FastSim":
        """B disjoint copies of this network as one block-diagonal FastSim;
        replica b owns nodes [b*n, (b+1)*n) and its own links/buffers."""
        cached = self._rep_cache.get(B)
        if cached is not None:
            return cached
        n = self.n
        hop = np.where(self.hop_delay >= _SENTINEL, np.inf,
                       self.hop_delay.astype(np.float64))
        base_tp = self.dest_dist * self.src_rate[:, None]
        nh = np.zeros((B * n, B * n), np.int64)
        hb = np.full((B * n, B * n), np.inf)
        tp = np.zeros((B * n, B * n), np.float64)
        for b in range(B):
            s = slice(b * n, (b + 1) * n)
            nh[s, s] = self.next_hop + b * n
            hb[s, s] = hop
            tp[s, s] = base_tp
        rep = FastSim(nh, hb, np.tile(self.node_delay, B), tp, self.cfg)
        self._rep_cache[B] = rep
        return rep

    # ------------------------------------------------------------------
    def run(self, injection_rate: float, config: SimConfig | None = None
            ) -> SimStats:
        return self.run_batch([injection_rate], config)[0]

    def run_batch(self, rates, config: SimConfig | None = None,
                  backend: str = "auto", device=None) -> list[SimStats]:
        """Run B independent simulations (one per injection rate) in a
        single vectorized pass. Each replica uses the same seed a solo
        ``run`` would, so results are identical to sequential runs.

        Backends (all bit-identical; only wall-clock differs):
        - ``'c'``: the cycle loop as one runtime-compiled C call
          (``sim/_ckernel.py``) — fastest by far;
        - ``'numpy'``: dense whole-array passes per cycle — no compiler
          needed, and the readable reference for the other two;
        - ``'torch'``: the fixed-shape cycle loop of
          ``sim/simfast_torch.py`` on ``device`` (the card unless the
          caller passes ``device="cpu"``; raises without a GPU) — the
          accelerator variant, opt-in; it never gives way to numpy;
        - ``'auto'`` (default): 'c' when a compiler is available, else
          'numpy' (both on the host).

        ``device`` is read by the torch backend only.
        """
        cfg = config or self.cfg
        if backend == "torch":
            from .simfast_torch import run_batch_torch
            return run_batch_torch(self, rates, cfg, device=device)
        if backend not in ("numpy", "c", "auto"):
            raise ValueError(f"unknown backend {backend!r}")
        rates = [float(r) for r in rates]
        B = len(rates)
        if B == 0:
            return []
        if backend in ("c", "auto"):
            from ._ckernel import get_kernel
            kernel = get_kernel()
            if kernel is not None:
                return self._run_batch_c(kernel, rates, cfg)
            if backend == "c":
                raise RuntimeError("backend='c' requires a working C "
                                   "compiler (cc) on PATH")
        net = self if B == 1 else self._replicated(B)
        bn = self.n                          # nodes per replica
        n = net.n
        V, cap, psize = cfg.num_vcs, cfg.buf_flits_per_vc, cfg.packet_size_flits
        L = net.n_links
        nb_link = L * V                      # link-VC buffers
        nb_tot = nb_link + n                 # + one injection queue per node
        nb_base = nb_link // B
        warm_end = cfg.warmup_cycles
        meas_end = warm_end + cfg.measure_cycles
        horizon = meas_end + cfg.drain_cycles
        dc = cfg.deadlock_cycles

        # ---- per-replica injection schedules (seeded like solo runs) -----
        pk_dst, pk_birth, offsets, offered, total = \
            self._prep_schedules(rates, cfg)
        pk_dst = pk_dst.astype(np.int32)
        pk_birth = pk_birth.astype(np.int32)
        offsets = offsets.astype(np.int32)
        pk_head_arr = np.full(total, -1, np.int32)
        inj_ptr = offsets[:-1].copy()        # current packet per node (CSR)
        inj_end = offsets[1:]
        inj_seq = np.zeros(n, np.int32)      # flit index in current packet

        # ---- dense per-buffer state --------------------------------------
        # Ring slots hold (packet*psize + seq, ready); the *head* flit of
        # every buffer is mirrored in dense arrays maintained incrementally
        # (only buffers whose head changed are refreshed), so per-cycle
        # passes are contiguous whole-array ops, not per-candidate gathers.
        # Buffer ids: [0, nb_link) = (link, VC) rings, [nb_link, nb_tot) =
        # injection queues; head attributes live in unified arrays so
        # eligibility/arbitration need no per-kind concatenation.
        ring_code = np.full((nb_link, cap), -1, np.int32)
        ring_ready = np.zeros((nb_link, cap), np.int32)
        head = np.zeros(nb_link, np.int32)
        cnt = np.zeros(nb_link, np.int32)
        head_ready = np.full(nb_link, _FAR32, np.int32)
        head_code = np.zeros(nb_link, np.int32)
        outl_all = np.zeros(nb_tot, np.int32)     # -1 = ejection port
        ready_all = np.zeros(nb_tot, bool)
        routed = np.zeros(nb_tot, bool)           # wormhole route per buffer
        route_tgt = np.zeros(nb_tot, np.int32)
        owner = np.full(nb_link, -1, np.int32)    # dst buffer -> src buffer
        linkbuf_node = np.repeat(net.link_dst, V).astype(np.int32)
        node_delay = net.node_delay.astype(np.int32)
        out_link = net.out_link.astype(np.int32)
        link_fwd_delay = net.link_fwd_delay.astype(np.int32)
        vc_iota = np.arange(V, dtype=np.int32)
        # replica-local id per buffer for the arbitration hash, so a replica
        # inside a batch arbitrates bit-identically to a solo run
        loc = np.concatenate((np.tile(np.arange(nb_base, dtype=np.int64), B),
                              nb_base + np.arange(n, dtype=np.int64) % bn))
        pa = (loc + 1) * _HASH_A

        inj_ready = np.full(n, _FAR32, np.int32)  # birth of current packet
        # a complete table (every same-replica pair has an outgoing link)
        # lets the refresh paths skip per-packet no-route checks
        rep_col = np.arange(n) // bn
        complete = bool(((out_link >= 0)
                         | (rep_col[:, None] != rep_col[None, :])
                         | np.eye(n, dtype=bool)).all())

        def _refresh_inj(nodes):
            alive = inj_ptr[nodes] < inj_end[nodes]
            inj_ready[nodes[~alive]] = _FAR32
            av = nodes[alive]
            if av.size:
                p = inj_ptr[av]
                inj_ready[av] = pk_birth[p]
                ol = out_link[av, pk_dst[p]]
                if not complete and ol.size and ol.min() < 0:
                    bad = int((ol < 0).nonzero()[0][0])
                    raise RuntimeError(
                        f"no route {av[bad]}->{pk_dst[p[bad]]}")
                outl_all[nb_link + av] = ol

        def _refresh_heads(bufs):
            tb = bufs[cnt[bufs] > 0]
            if not tb.size:
                return
            h = head[tb]
            code = ring_code[tb, h]
            head_code[tb] = code
            head_ready[tb] = ring_ready[tb, h]
            d = pk_dst[code // psize]
            nodes = linkbuf_node[tb]
            ol = out_link[nodes, d]
            ej = d == nodes
            if not complete and (~ej & (ol < 0)).any():
                bad = int((~ej & (ol < 0)).nonzero()[0][0])
                raise RuntimeError(f"no route {nodes[bad]}->{d[bad]}")
            outl_all[tb] = np.where(ej, -1, ol)

        _refresh_inj(np.arange(n))

        lat_sum = np.zeros(B)
        head_lat_sum = np.zeros(B)
        measured = np.zeros(B, np.int64)
        accepted = np.zeros(B, np.int64)
        last_progress = np.zeros(B, np.int32)
        deadlock = np.zeros(B, bool)

        def _purge(mask):
            """Kill deadlocked replicas: drop their flits + schedules."""
            deadlock[mask] = True
            cnt.reshape(B, nb_base)[mask] = 0
            inj_ready.reshape(B, bn)[mask] = _FAR32
            for b in mask.nonzero()[0]:
                inj_ptr[b * bn:(b + 1) * bn] = inj_end[b * bn:(b + 1) * bn]

        ready_l = ready_all[:nb_link]        # views, written in place
        ready_i = ready_all[nb_link:]
        cnt_nz = np.empty(nb_link, bool)
        min_lp = 0                           # min(last_progress), tracked

        cycle = 0
        while cycle < horizon:
            np.greater(cnt, 0, out=cnt_nz)
            np.less_equal(head_ready, cycle, out=ready_l)
            np.logical_and(ready_l, cnt_nz, out=ready_l)
            np.less_equal(inj_ready, cycle, out=ready_i)
            if not ready_all.any():
                # Idle: nothing can move. Jump to the next event (bounded by
                # the watchdog window so deadlock semantics are preserved).
                flits = cnt_nz.any()
                if not flits and int(inj_ready.min()) >= _FAR32:
                    break                    # fully drained, nothing pending
                has_flits = cnt_nz.reshape(B, nb_base).any(axis=1)
                over = has_flits & (cycle - last_progress > dc)
                if over.any():
                    _purge(over)
                    continue
                nxt = min(int(np.where(cnt_nz, head_ready, _FAR32).min()),
                          int(inj_ready.min()), horizon)
                if flits:
                    nxt = min(nxt, int(last_progress[has_flits].min())
                              + dc + 1)
                cycle = max(cycle + 1, nxt)
                continue

            cyc_h = np.int64(cycle) * _HASH_B
            prog = []

            # ---- decisions (all from start-of-cycle state) ---------------
            ej = (ready_l & (outl_all[:nb_link] < 0)).nonzero()[0]
            free_vc = (owner < 0) & (cnt < cap)
            alloc_ok = free_vc.reshape(L, V).any(axis=1)     # per link
            credit = cnt[route_tgt] < cap
            elig = ready_all & (outl_all >= 0) & np.where(routed, credit,
                                                          alloc_ok[outl_all])
            el = elig.nonzero()[0]

            # ---- ejection: one flit per node per cycle -------------------
            if ej.size:
                pr = (pa[ej] + cyc_h) & _PRIO_MASK
                w = ej[_winners(linkbuf_node[ej], pr)]
                code = head_code[w]
                pktw = code // psize
                seqw = code - pktw * psize
                nodes = linkbuf_node[w]
                head[w] = (head[w] + 1) % cap
                cnt[w] -= 1
                nd = node_delay[nodes]
                hm = seqw == 0
                pk_head_arr[pktw[hm]] = cycle + nd[hm]
                tw = (seqw == psize - 1).nonzero()[0]
                if tw.size:
                    tpk = pktw[tw]
                    births = pk_birth[tpk]
                    mi = ((births >= warm_end)
                          & (births < meas_end)).nonzero()[0]
                    if mi.size:
                        rep = nodes[tw[mi]] // bn
                        lat_sum += np.bincount(
                            rep, weights=cycle + nd[tw[mi]] - births[mi],
                            minlength=B)
                        head_lat_sum += np.bincount(
                            rep, weights=pk_head_arr[tpk[mi]] - births[mi],
                            minlength=B)
                        done = np.bincount(rep, minlength=B)
                        measured += done
                        accepted += psize * done
                prog.append(nodes // bn)

            # ---- forwarding: one winner per output link ------------------
            if el.size:
                wol_all = outl_all[el]
                pr = (pa[el] + cyc_h) & _PRIO_MASK
                wsel = _winners(wol_all, pr)
                wbuf = el[wsel]
                wol = wol_all[wsel]
                is_i = wbuf >= nb_link
                wl = wbuf[~is_i]
                wi = wbuf[is_i] - nb_link
                nw = wbuf.size
                pktw = np.empty(nw, np.int64)
                seqw = np.empty(nw, np.int64)
                nodew = np.empty(nw, np.int64)
                codel = head_code[wl]
                pktw[~is_i] = codel // psize
                seqw[~is_i] = codel - codel // psize * psize
                nodew[~is_i] = linkbuf_node[wl]
                pktw[is_i] = inj_ptr[wi]
                seqw[is_i] = inj_seq[wi]
                nodew[is_i] = wi
                wtgt = route_tgt[wbuf]          # fancy index: already a copy
                # head flits allocate the lowest free, non-full VC on their
                # output link (body flits always carry a route)
                new = (~routed[wbuf]).nonzero()[0]
                if new.size:
                    base = wol[new, None] * V + vc_iota
                    nt = wol[new] * V + free_vc[base].argmax(axis=1)
                    wtgt[new] = nt
                    owner[nt] = wbuf[new]
                    routed[wbuf[new]] = True
                    route_tgt[wbuf[new]] = nt
                # pop winners from their source buffers
                head[wl] = (head[wl] + 1) % cap
                cnt[wl] -= 1
                if wi.size:
                    inj_seq[wi] += 1
                    fin = (inj_seq[wi] == psize).nonzero()[0]
                    if fin.size:
                        fn = wi[fin]
                        inj_seq[fn] = 0
                        inj_ptr[fn] += 1
                        _refresh_inj(fn)
                # push into target rings (after pops: slots are exact)
                newly = wtgt[cnt[wtgt] == 0]     # targets gaining a head flit
                slot = (head[wtgt] + cnt[wtgt]) % cap
                ring_code[wtgt, slot] = pktw * psize + seqw
                ring_ready[wtgt, slot] = cycle + link_fwd_delay[wol]
                cnt[wtgt] += 1
                # tail flits release the wormhole route + VC ownership
                tl = seqw == psize - 1
                routed[wbuf[tl]] = False
                route_tgt[wbuf[tl]] = 0
                owner[wtgt[tl]] = -1
                prog.append(nodew // bn)
                # heads changed: popped link buffers + newly non-empty tgts
                if ej.size:
                    _refresh_heads(np.concatenate((w, wl, newly)))
                else:
                    _refresh_heads(np.concatenate((wl, newly)))
            elif ej.size:
                _refresh_heads(w)

            # ---- progress bookkeeping + deadlock watchdog ----------------
            if prog:
                rep = prog[0] if len(prog) == 1 else np.concatenate(prog)
                last_progress[rep] = cycle
                min_lp = int(last_progress.min())
            if cycle - min_lp > dc:
                stale = cycle - last_progress > dc
                has_flits = cnt.reshape(B, nb_base).any(axis=1)
                born = (inj_ready <= cycle).reshape(B, bn).any(axis=1)
                trip = stale & (has_flits | born)
                if trip.any():
                    _purge(trip)
                last_progress[stale & ~trip] = cycle   # drained: stop timing
                min_lp = int(last_progress.min())
            cycle += 1

        return assemble_stats(bn, cfg, offered, lat_sum, head_lat_sum,
                              measured, accepted, deadlock)


    def _run_batch_c(self, kernel, rates, cfg) -> list[SimStats]:
        """Dispatch one batch to the compiled C kernel (see _ckernel.py)."""
        import ctypes

        B = len(rates)
        net = self if B == 1 else self._replicated(B)
        bn = self.n
        n = net.n
        V, cap, psize = cfg.num_vcs, cfg.buf_flits_per_vc, cfg.packet_size_flits
        L = net.n_links
        nb_link = L * V
        nb_tot = nb_link + n
        nb_base = nb_link // B
        warm_end = cfg.warmup_cycles
        meas_end = warm_end + cfg.measure_cycles
        horizon = meas_end + cfg.drain_cycles

        pk_dst, pk_birth, offsets, offered, total = \
            self._prep_schedules(rates, cfg)
        pk_dst = pk_dst.astype(np.int32)
        pk_birth = pk_birth.astype(np.int32)
        offsets = offsets.astype(np.int32)
        if total == 0:      # nothing will ever happen; give the kernel a
            pk_dst = np.zeros(1, np.int32)       # non-null pointer anyway
            pk_birth = np.zeros(1, np.int32)
        inj_ptr = offsets[:-1].copy()
        inj_end = offsets[1:].copy()
        inj_seq = np.zeros(n, np.int32)

        ring_code = np.zeros(nb_link * cap, np.int32)
        ring_ready = np.zeros(nb_link * cap, np.int32)
        head = np.zeros(nb_link, np.int32)
        cnt = np.zeros(nb_link, np.int32)
        route_tgt = np.full(nb_tot, -1, np.int32)
        owner = np.full(nb_link, -1, np.int32)
        pk_head_arr = np.full(max(total, 1), -1, np.int32)
        lat_sum = np.zeros(B, np.float64)
        head_lat_sum = np.zeros(B, np.float64)
        measured = np.zeros(B, np.int64)
        accepted = np.zeros(B, np.int64)
        last_progress = np.zeros(B, np.int32)
        deadlock = np.zeros(B, np.uint8)

        loc = np.concatenate((np.tile(np.arange(nb_base, dtype=np.int64), B),
                              nb_base + np.arange(n, dtype=np.int64) % bn))
        pa = (loc + 1) * _HASH_A
        link_dst = net.link_dst.astype(np.int32)
        out_link = np.ascontiguousarray(net.out_link.astype(np.int32))
        link_fwd_delay = net.link_fwd_delay.astype(np.int32)
        node_delay = net.node_delay.astype(np.int32)
        params = np.array([B, bn, L, V, cap, psize, n, warm_end, meas_end,
                           horizon, cfg.deadlock_cycles], np.int64)

        def p32(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

        def p64(a):
            return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))

        rc = kernel(p64(params), p32(link_dst), p32(out_link),
                    p32(link_fwd_delay), p32(node_delay), p64(pa),
                    p32(pk_dst), p32(pk_birth), p32(inj_ptr), p32(inj_end),
                    p32(inj_seq), p32(ring_code), p32(ring_ready),
                    p32(head), p32(cnt), p32(route_tgt), p32(owner),
                    p32(pk_head_arr),
                    lat_sum.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_double)),
                    head_lat_sum.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_double)),
                    p64(measured), p64(accepted), p32(last_progress),
                    deadlock.ctypes.data_as(
                        ctypes.POINTER(ctypes.c_uint8)))
        if rc < 0:
            if rc <= -1000000000:
                raise MemoryError("C kernel allocation failed")
            raise RuntimeError(f"no route from node {-int(rc) - 1}")

        return assemble_stats(bn, cfg, offered, lat_sum, head_lat_sum,
                              measured, accepted, deadlock)


def fast_sim_from_design(design, traffic: np.ndarray,
                         config: SimConfig | None = None) -> FastSim:
    """Build a FastSim from a Design + traffic matrix using the same
    prepared arrays (graph + routing table) as the proxies — the FastSim
    variant of ``sim_from_design`` (one shared implementation, so both
    engines always see identical inputs)."""
    from .cyclesim import sim_from_design

    return sim_from_design(design, traffic, config, cls=FastSim)
