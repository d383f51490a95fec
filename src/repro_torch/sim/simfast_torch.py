"""PyTorch backend for ``FastSim.run_batch``; the counterpart of the
reference's jitted XLA backend ``src/repro/sim/simfast_jax.py``.

The cycle loop runs over fixed-shape state on one device: the same
struct-of-arrays model as the numpy path (ring buffers per (link, VC), dense
head-flit mirrors, hashed rotating arbitration, credit/VC-allocation rules,
the deadlock watchdog), written as masked whole-array ops. Decisions are
bit-identical to the numpy backend, so every ``SimStats`` field is equal
(asserted in tests/test_torch_sim.py); only wall-clock differs. The
reference backend is XLA code with no Pallas kernel, so this one is plain
PyTorch: there is no hand-written kernel here.

How the reference's ``lax.while_loop`` becomes a loop that stays on the
device:

- **Frozen cycles.** Each cycle first computes the loop condition on the
  device (``cycle < horizon`` and a flit or a pending packet left) and ands
  it into every lane mask. Once it is false, every scatter goes to a spare
  row and every whole-array update keeps its value, so the state stops
  changing. ``K_CYCLES`` cycles then run between two host checks of the
  condition without changing a bit.
- **CUDA graphs.** On the card a ``K_CYCLES``-cycle chunk (hundreds of small
  kernels a cycle) is captured once per shape signature into a
  ``torch.cuda.CUDAGraph`` over static state tensors and replayed; the host
  reads one flag a chunk. Captured runners are cached per shape signature
  (the reference caches its jitted programs the same way).
- **Capture-safe ops.** Nothing in a cycle copies from the host: scalar
  writes go through ``index_fill_`` and ``fill_``, never through
  ``x[idx] = python_scalar`` (which stages a host tensor).
- **Spare rows.** Every scatter target carries one spare row; masked-out
  lanes scatter into it (link-buffer arrays at ``nb_link``, route arrays at
  ``nb_tot``, injection arrays at ``n``, packet arrays at ``k_pad``). A set
  scatter outside the spare row never sees a duplicate index except where
  every duplicate writes the same value (the head refresh), so CUDA's
  unordered ``index_put_`` gives the numpy backend's bits.
- **Integer types.** The arbitration hash works in int64 and keeps the low
  31 bits, which equal the reference's uint32 arithmetic (``& 0x7FFFFFFF``
  of a sum does not see the bits above 2^32). One-winner selections are
  ``scatter_reduce_(..., "amin")`` over packed (priority, buffer) keys.
  The latency sums are float64 sums of whole cycle counts, exact in any
  order below 2^53, so ``index_add_``'s order does not matter.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

import numpy as np
import torch

from ..utils.device import resolve_device
from .cyclesim import SimConfig, SimStats

_FAR = 1 << 30
_HASH_A = 2654435761
_HASH_B = 40503
_BIG = 1 << 62
K_CYCLES = 64          # cycles between two host checks (one CUDA graph)
_CACHE_SIZE = 4        # captured runners kept, least recently used evicted

_RUNNERS: OrderedDict = OrderedDict()
_RUNNERS_LOCK = threading.Lock()


def _pow2_bucket(k: int) -> int:
    b = 1024
    while b < k:
        b *= 2
    return b


class _Runner:
    """Static state and constant tensors for one shape signature, the
    per-cycle step over them, and (on CUDA) the captured K-cycle graph."""

    def __init__(self, key, device: torch.device, cuda_graph: bool):
        (B, bn, L, V, cap, psize, k_pad, warm_end, meas_end, horizon,
         dc) = key
        self.device = device
        n = B * bn
        nb_link = L * V
        nb_tot = nb_link + n
        self.dims = dict(B=B, bn=bn, L=L, V=V, cap=cap, psize=psize,
                         k_pad=k_pad, warm_end=warm_end, meas_end=meas_end,
                         horizon=horizon, dc=dc, n=n, nb_link=nb_link,
                         nb_tot=nb_tot, nb_base=nb_link // B)
        i64, dev = torch.int64, device

        def z(*shape, dtype=i64):
            return torch.zeros(shape, dtype=dtype, device=dev)

        self.st = {
            "cycle": z(), "ring_code": z((nb_link + 1) * cap),
            "ring_ready": z((nb_link + 1) * cap), "head": z(nb_link + 1),
            "cnt": z(nb_link + 1), "head_ready": z(nb_link + 1),
            "head_code": z(nb_link + 1), "outl": z(nb_tot + 1),
            "routed": z(nb_tot + 1, dtype=torch.bool),
            "route_tgt": z(nb_tot + 1), "owner": z(nb_link + 1),
            "inj_ptr": z(n + 1), "inj_seq": z(n + 1), "inj_ready": z(n + 1),
            "pk_head_arr": z(k_pad + 1),
            "lat_sum": z(B, dtype=torch.float64),
            "head_lat_sum": z(B, dtype=torch.float64),
            "measured": z(B), "accepted": z(B), "last_progress": z(B),
            "deadlock": z(B, dtype=torch.bool)}
        self.c = {
            "out_link": z(n, n), "lbn_sp": z(nb_link + 1),
            "link_fwd_delay": z(L), "node_delay": z(n), "pa": z(nb_tot),
            "rep_node": z(n), "rep_node_sp": z(n + 1), "rep_link": z(L),
            "rep_buf": z(nb_link), "pk_dst_sp": z(k_pad + 1),
            "pk_birth_sp": z(k_pad + 1), "inj_end_sp": z(n + 1)}
        # shape-only constants
        self.iota_link = torch.arange(nb_link, dtype=i64, device=dev)
        self.iota_tot = torch.arange(nb_tot, dtype=i64, device=dev)
        self.iota_L = torch.arange(L, dtype=i64, device=dev)
        self.iota_V = torch.arange(V, dtype=i64, device=dev)
        self.ones_n = torch.ones(n, dtype=i64, device=dev)
        self.ones_L = torch.ones(L, dtype=i64, device=dev)
        self.big_n = torch.full((n,), _BIG, dtype=i64, device=dev)
        self.big_L1 = torch.full((L + 1,), _BIG, dtype=i64, device=dev)
        self.no_alloc = torch.zeros(1, dtype=torch.bool, device=dev)
        self.graph = None
        if cuda_graph and device.type == "cuda":
            self._capture()

    # -- one cycle ------------------------------------------------------------
    def step(self) -> None:
        """One cycle, in place on the static state; a no-op once the loop
        condition is false (see the module docstring)."""
        d, st, c = self.dims, self.st, self.c
        n, nb_link, nb_tot, L, V = (d["n"], d["nb_link"], d["nb_tot"],
                                    d["L"], d["V"])
        cap, psize, k_pad, B = d["cap"], d["psize"], d["k_pad"], d["B"]
        cycle, cnt, head, head_ready, head_code, outl = (
            st["cycle"], st["cnt"], st["head"], st["head_ready"],
            st["head_code"], st["outl"])
        routed, route_tgt, owner = st["routed"], st["route_tgt"], st["owner"]
        inj_ptr, inj_seq, inj_ready = (st["inj_ptr"], st["inj_seq"],
                                       st["inj_ready"])
        ring_code, ring_ready, pk_head_arr = (st["ring_code"],
                                              st["ring_ready"],
                                              st["pk_head_arr"])
        where = torch.where

        act = (cycle < d["horizon"]) & (
            (cnt[:nb_link] > 0).any() | (inj_ready[:n] < _FAR).any())
        cnt0 = cnt.clone()            # decisions use start-of-cycle occupancy
        ready_l = (cnt[:nb_link] > 0) & (head_ready[:nb_link] <= cycle)
        ready_i = inj_ready[:n] <= cycle
        prio = (c["pa"] + cycle * _HASH_B) & 0x7FFFFFFF

        # ---- ejection: one winner per node -------------------------------
        ej_mask = ready_l & (outl[:nb_link] < 0) & act
        ekey = where(ej_mask, (prio[:nb_link] << 20) | self.iota_link, _BIG)
        node_min = self.big_n.clone().scatter_reduce_(
            0, c["lbn_sp"][:nb_link], ekey, "amin")
        ej_valid = node_min < _BIG
        ebuf = where(ej_valid, node_min & 0xFFFFF, nb_link)
        ecode = head_code[ebuf]
        epkt = where(ej_valid, ecode // psize, k_pad)
        eseq = ecode - (ecode // psize) * psize
        head[ebuf] = (head[ebuf] + 1) % cap
        cnt.index_add_(0, ebuf, -self.ones_n)
        nd = c["node_delay"]
        is_h = ej_valid & (eseq == 0)
        pk_head_arr[where(is_h, epkt, k_pad)] = cycle + nd
        is_t = ej_valid & (eseq == psize - 1)
        tpk = where(is_t, epkt, k_pad)
        tb = c["pk_birth_sp"][tpk]
        meas = is_t & (tb >= d["warm_end"]) & (tb < d["meas_end"])
        lat = (cycle + nd - tb).to(torch.float64)
        hlat = (pk_head_arr[tpk] - tb).to(torch.float64)
        rep_node = c["rep_node"]
        st["lat_sum"].index_add_(0, rep_node, where(meas, lat, 0.0))
        st["head_lat_sum"].index_add_(0, rep_node, where(meas, hlat, 0.0))
        md = meas.to(torch.int64)
        st["measured"].index_add_(0, rep_node, md)
        st["accepted"].index_add_(0, rep_node, psize * md)

        # ---- forwarding: one winner per output link ----------------------
        free_vc = ((owner[:nb_link] < 0) & (cnt0[:nb_link] < cap)).view(L, V)
        alloc_sp = torch.cat([free_vc.any(dim=1), self.no_alloc])
        credit = cnt0[route_tgt[:nb_tot]] < cap     # route_tgt default 0
        outl_r = outl[:nb_tot]
        outl_cl = where(outl_r >= 0, outl_r, L)
        elig = (torch.cat([ready_l, ready_i]) & (outl_r >= 0)
                & where(routed[:nb_tot], credit, alloc_sp[outl_cl]) & act)
        fkey = where(elig, (prio << 20) | self.iota_tot, _BIG)
        w_key = self.big_L1.clone().scatter_reduce_(0, outl_cl, fkey,
                                                    "amin")[:L]
        w_valid = w_key < _BIG
        wb = where(w_valid, w_key & 0xFFFFF, nb_tot)
        is_i = w_valid & (wb >= nb_link)
        lb = where(w_valid & ~is_i, wb, nb_link)        # link sources
        il = where(is_i, wb - nb_link, n)               # injection sources
        codel = head_code[lb]
        pktl = codel // psize
        pkt = where(is_i, inj_ptr[il], pktl)
        seq = where(is_i, inj_seq[il], codel - pktl * psize)
        # VC allocation: the lowest free, non-full VC on this link (VC 0
        # where none is free, as argmax of all-false; never used then)
        first = where(free_vc, self.iota_V, V).amin(dim=1)
        alloc_t = self.iota_L * V + where(first < V, first, 0)
        rt = routed[wb]
        tgt = where(rt, route_tgt[wb], alloc_t)
        do_alloc = w_valid & ~rt
        owner[where(do_alloc, tgt, nb_link)] = where(do_alloc, wb, -1)
        routed.index_fill_(0, where(do_alloc, wb, nb_tot), True)
        route_tgt[where(do_alloc, wb, nb_tot)] = tgt
        # pops: link sources
        head[lb] = (head[lb] + 1) % cap
        cnt.index_add_(0, lb, -self.ones_L)
        # pops: injection sources (advance the packet on its tail)
        s2 = inj_seq[il] + 1
        fin = is_i & (s2 == psize)
        inj_seq[il] = where(fin, 0, s2)
        p2 = inj_ptr[il] + fin.to(torch.int64)
        inj_ptr[il] = p2
        alive = fin & (p2 < c["inj_end_sp"][il])
        pslot = where(alive, p2, k_pad)
        inj_ready[il] = where(fin, where(alive, c["pk_birth_sp"][pslot], _FAR),
                              inj_ready[il])
        nol = c["out_link"][where(il < n, il, 0), c["pk_dst_sp"][pslot]]
        outl[where(fin, nb_link + il, nb_tot)] = nol
        # pushes (slots exact after the pops)
        pt = where(w_valid, tgt, nb_link)
        cnt_pt = cnt[pt]
        newly = (cnt_pt == 0) & w_valid
        flat = pt * cap + (head[pt] + cnt_pt) % cap
        ring_code[flat] = pkt * psize + seq
        ring_ready[flat] = cycle + c["link_fwd_delay"]
        cnt.index_add_(0, pt, self.ones_L)
        # tails release route + VC ownership
        tail = w_valid & (seq == psize - 1)
        owner.index_fill_(0, where(tail, tgt, nb_link), -1)
        routed.index_fill_(0, where(tail, wb, nb_tot), False)
        route_tgt.index_fill_(0, where(tail, wb, nb_tot), 0)

        # ---- refresh the dense head mirrors of changed buffers -----------
        refresh = torch.cat([ebuf, lb, where(newly, pt, nb_link)])
        rb = where(cnt[refresh] > 0, refresh, nb_link)
        rflat = rb * cap + head[rb]
        rcode = ring_code[rflat]
        head_code[rb] = rcode
        head_ready[rb] = ring_ready[rflat]
        rd = c["pk_dst_sp"][torch.clamp(rcode // psize, 0, k_pad)]
        rnodes = c["lbn_sp"][rb]
        outl[where(rb < nb_link, rb, nb_tot)] = where(
            rd == rnodes, -1, c["out_link"][rnodes, rd])

        # ---- progress + deadlock watchdog --------------------------------
        prog = torch.zeros(B, dtype=torch.int64, device=self.device)
        prog.index_add_(0, rep_node, ej_valid.to(torch.int64))
        prog.index_add_(0, c["rep_link"], w_valid.to(torch.int64))
        last_progress = st["last_progress"]
        last_progress.copy_(where(prog > 0, cycle, last_progress))
        stale = ((cycle - last_progress) > d["dc"]) & act
        has_flits = (cnt[:nb_link].view(B, d["nb_base"]) > 0).any(dim=1)
        born = (inj_ready[:n] <= cycle).view(B, d["bn"]).any(dim=1)
        trip = stale & (has_flits | born)
        st["deadlock"] |= trip
        cnt[:nb_link] = where(trip[c["rep_buf"]], 0, cnt[:nb_link])
        trip_node = trip[c["rep_node_sp"]]
        inj_ready.copy_(where(trip_node, _FAR, inj_ready))
        inj_ptr.copy_(where(trip_node, c["inj_end_sp"], inj_ptr))
        last_progress.copy_(where(stale & ~trip, cycle, last_progress))

        # spare rows stay inert
        cnt[nb_link:].fill_(0)
        head[nb_link:].fill_(0)
        head_ready[nb_link:].fill_(_FAR)
        cycle += act.to(torch.int64)

    def running(self) -> bool:
        """The loop condition on the host (one device read)."""
        d, st = self.dims, self.st
        return bool(((st["cycle"] < d["horizon"]) & (
            (st["cnt"][:d["nb_link"]] > 0).any()
            | (st["inj_ready"][:d["n"]] < _FAR).any())).item())

    def _capture(self) -> None:
        """Capture ``K_CYCLES`` steps into a CUDA graph. The warm-up step
        runs with the cycle at the horizon, so it changes nothing that a
        run reads (only spare rows)."""
        self.st["cycle"].fill_(self.dims["horizon"])
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.step()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(K_CYCLES):
                self.step()
        self.graph = graph

    # -- one run ----------------------------------------------------------------
    def run(self, consts: dict, init: dict) -> dict:
        """Load this run's constants and initial state into the static
        tensors, run to the end, and return the accumulators on the host."""
        for name, value in consts.items():
            self.c[name].copy_(torch.as_tensor(value))
        for name, value in init.items():
            t = self.st[name]
            if isinstance(value, np.ndarray):
                t.copy_(torch.as_tensor(value))
            else:
                t.fill_(value)
        while self.running():
            if self.graph is not None:
                self.graph.replay()
            else:
                for _ in range(K_CYCLES):
                    self.step()
        return {k: self.st[k].cpu().numpy() for k in (
            "lat_sum", "head_lat_sum", "measured", "accepted", "deadlock",
            "cycle")}


def _runner(key, device: torch.device, cuda_graph: bool) -> _Runner:
    full_key = (key, str(device), cuda_graph)
    runner = _RUNNERS.get(full_key)
    if runner is None:
        runner = _Runner(key, device, cuda_graph)
        _RUNNERS[full_key] = runner
        while len(_RUNNERS) > _CACHE_SIZE:
            _RUNNERS.popitem(last=False)
    _RUNNERS.move_to_end(full_key)
    return runner


def run_batch_torch(sim, rates, cfg: SimConfig, device=None,
                    cuda_graph: bool = True) -> list[SimStats]:
    """Execute ``FastSim.run_batch`` semantics on ``device`` (None means
    the card, and raises without one; ``"cpu"`` runs the same loop on the
    host). ``cuda_graph=False`` runs the card's cycles eagerly, one launch
    per op (for timing the graph against)."""
    from .simfast import assemble_stats

    dev = resolve_device(device)
    rates = [float(r) for r in rates]
    B = len(rates)
    if B == 0:
        return []
    net = sim if B == 1 else sim._replicated(B)
    bn = sim.n
    n = net.n
    V, cap, psize = cfg.num_vcs, cfg.buf_flits_per_vc, cfg.packet_size_flits
    L = net.n_links
    nb_link = L * V
    nb_tot = nb_link + n
    nb_base = nb_link // B
    warm_end = cfg.warmup_cycles
    meas_end = warm_end + cfg.measure_cycles
    horizon = meas_end + cfg.drain_cycles
    if nb_tot >= (1 << 20):
        raise RuntimeError("network too large for the packed-key torch "
                           "backend; use the numpy backend")

    # ---- schedules (identical to the numpy backend) ----------------------
    pk_dst, pk_birth, offsets, offered, total = \
        sim._prep_schedules(rates, cfg)
    k_pad = _pow2_bucket(max(total, 1))
    pk_dst_sp = np.zeros(k_pad + 1, np.int64)
    pk_birth_sp = np.full(k_pad + 1, _FAR, np.int64)
    if total:
        pk_dst_sp[:total] = pk_dst
        pk_birth_sp[:total] = pk_birth
    offsets = offsets.astype(np.int64)

    # ---- constants --------------------------------------------------------
    out_link = net.out_link.astype(np.int64)
    rep_col = np.arange(n) // bn
    same_rep = rep_col[:, None] == rep_col[None, :]
    if not bool(((out_link >= 0) | ~same_rep
                 | np.eye(n, dtype=bool)).all()):
        raise RuntimeError("torch backend requires a complete routing table")
    lbn_sp = np.zeros(nb_link + 1, np.int64)
    lbn_sp[:nb_link] = np.repeat(net.link_dst, V)
    loc = np.concatenate((np.tile(np.arange(nb_base, dtype=np.int64), B),
                          nb_base + np.arange(n, dtype=np.int64) % bn))
    rep_node = np.arange(n, dtype=np.int64) // bn
    rep_link = (net.link_src // bn).astype(np.int64)
    inj_end_sp = np.zeros(n + 1, np.int64)
    inj_end_sp[:n] = offsets[1:]
    consts = {
        "out_link": out_link, "lbn_sp": lbn_sp,
        "link_fwd_delay": net.link_fwd_delay.astype(np.int64),
        "node_delay": net.node_delay.astype(np.int64),
        "pa": (loc + 1) * _HASH_A, "rep_node": rep_node,
        "rep_node_sp": np.append(rep_node, 0), "rep_link": rep_link,
        "rep_buf": np.repeat(rep_link, V), "pk_dst_sp": pk_dst_sp,
        "pk_birth_sp": pk_birth_sp, "inj_end_sp": inj_end_sp}

    # ---- initial state ----------------------------------------------------
    inj_ptr0 = np.zeros(n + 1, np.int64)
    inj_ptr0[:n] = offsets[:-1]
    inj_ready0 = np.full(n + 1, _FAR, np.int64)
    outl0 = np.full(nb_tot + 1, -1, np.int64)
    live = (inj_ptr0[:n] < inj_end_sp[:n]).nonzero()[0]
    if live.size:
        p = inj_ptr0[live]
        inj_ready0[live] = pk_birth_sp[p]
        outl0[nb_link + live] = out_link[live, pk_dst_sp[p]]
    init = {"cycle": 0, "ring_code": -1, "ring_ready": 0, "head": 0,
            "cnt": 0, "head_ready": _FAR, "head_code": 0, "outl": outl0,
            "routed": False, "route_tgt": 0, "owner": -1,
            "inj_ptr": inj_ptr0, "inj_seq": 0, "inj_ready": inj_ready0,
            "pk_head_arr": 0, "lat_sum": 0.0, "head_lat_sum": 0.0,
            "measured": 0, "accepted": 0, "last_progress": 0,
            "deadlock": False}

    key = (B, bn, L, V, cap, psize, k_pad, warm_end, meas_end, horizon,
           cfg.deadlock_cycles)
    with _RUNNERS_LOCK, torch.no_grad():
        res = _runner(key, dev, cuda_graph).run(consts, init)
    return assemble_stats(bn, cfg, offered, res["lat_sum"],
                          res["head_lat_sum"], res["measured"],
                          res["accepted"], res["deadlock"])


__all__ = ["run_batch_torch", "K_CYCLES"]
