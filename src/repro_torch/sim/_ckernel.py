# Copy of src/repro/sim/_ckernel.py.
"""Runtime-compiled C kernel for ``FastSim.run_batch``.

The numpy backend's per-cycle array passes have an irreducible dispatch
floor (~100 numpy calls/cycle); this kernel runs the identical cycle loop
— same candidate rules, same hashed arbitration, same credit/VC-allocation
decisions, same watchdog — as one C function over the same int32 arrays,
eliminating that floor entirely. Results are bit-identical to the numpy
backend (asserted in tests/test_torch_sim.py).

The kernel is plain C with a pointer-only ABI (no Python.h), compiled once
per machine with whatever ``cc`` is on PATH into a content-hash-named
shared object under the user cache dir, and loaded via ctypes. If no
compiler is available the caller falls back to the numpy backend — the
kernel is an accelerator, never a dependency.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

from ..utils import env as _env

_SOURCE = r"""
#include <stdint.h>
#include <stdlib.h>
#include <string.h>

#define HASH_A 2654435761LL
#define HASH_B 40503LL
#define PRIO_MASK 0x7FFFFFFFLL

/* params: B bn L V cap psize n warm_end meas_end horizon dc */
int64_t run_sim(const int64_t *P,
                const int32_t *link_dst, const int32_t *out_link,
                const int32_t *link_fwd_delay, const int32_t *node_delay,
                const int64_t *pa,
                const int32_t *pk_dst, const int32_t *pk_birth,
                int32_t *inj_ptr, const int32_t *inj_end, int32_t *inj_seq,
                int32_t *ring_code, int32_t *ring_ready,
                int32_t *head, int32_t *cnt,
                int32_t *route_tgt, int32_t *owner, int32_t *pk_head_arr,
                double *lat_sum, double *head_lat_sum,
                int64_t *measured, int64_t *accepted,
                int32_t *last_progress, uint8_t *deadlock)
{
    const int B = (int)P[0], bn = (int)P[1], L = (int)P[2], V = (int)P[3];
    const int cap = (int)P[4], psize = (int)P[5], n = (int)P[6];
    const int warm_end = (int)P[7], meas_end = (int)P[8];
    const int horizon = (int)P[9], dc = (int)P[10];
    const int nb_link = L * V;
    const int nb_base = nb_link / B;
    const int ngroups = L + n;            /* forward links + ejection ports */

    int64_t *best_key = malloc(sizeof(int64_t) * ngroups);
    int32_t *best_buf = malloc(sizeof(int32_t) * ngroups);
    int32_t *stamp = calloc(ngroups, sizeof(int32_t));
    int32_t *touched = malloc(sizeof(int32_t) * ngroups);
    int32_t *win_tgt = malloc(sizeof(int32_t) * L);
    int64_t *flits = calloc(B, sizeof(int64_t));
    int64_t *pending = calloc(B, sizeof(int64_t));
    uint8_t *prog = calloc(B, sizeof(uint8_t));
    if (!best_key || !best_buf || !stamp || !touched || !win_tgt || !flits
        || !pending || !prog)
        return -1000000000;

    int64_t total_flits = 0, total_pending = 0;
    for (int u = 0; u < n; u++) {
        pending[u / bn] += inj_end[u] - inj_ptr[u];
        total_pending += inj_end[u] - inj_ptr[u];
    }

    int64_t err = 0;
    int cycle = 0;
    for (; cycle < horizon; cycle++) {
        if (total_flits == 0 && total_pending == 0)
            break;                       /* fully drained, nothing pending */
        const int64_t cyc_h = (int64_t)cycle * HASH_B;
        int ntouched = 0;
        const int32_t cstamp = cycle + 1;   /* stamps start at 0 */

        /* ---- pass 1: decide winners (start-of-cycle state only) ---- */
        for (int b = 0; b < nb_link + n; b++) {
            int node, pktid, group;
            if (b < nb_link) {
                if (!cnt[b] || ring_ready[b * cap + head[b]] > cycle)
                    continue;
                pktid = ring_code[b * cap + head[b]] / psize;
                node = link_dst[b / V];
                int dst = pk_dst[pktid];
                if (dst == node) {
                    group = L + node;    /* ejection port */
                } else {
                    int l = out_link[(int64_t)node * n + dst];
                    if (l < 0) { err = -1 - node; goto done; }
                    int tgt = route_tgt[b];
                    if (tgt >= 0) {
                        if (cnt[tgt] >= cap) continue;      /* no credit */
                    } else {
                        int ok = 0, base = l * V;
                        for (int v = 0; v < V; v++)
                            if (owner[base + v] < 0 && cnt[base + v] < cap)
                                { ok = 1; break; }
                        if (!ok) continue;        /* no allocatable VC */
                    }
                    group = l;
                }
            } else {
                int u = b - nb_link;
                if (inj_ptr[u] >= inj_end[u]
                    || pk_birth[inj_ptr[u]] > cycle)
                    continue;
                pktid = inj_ptr[u];
                node = u;
                int dst = pk_dst[pktid];
                int l = out_link[(int64_t)node * n + dst];
                if (l < 0) { err = -1 - node; goto done; }
                int tgt = route_tgt[b];
                if (tgt >= 0) {
                    if (cnt[tgt] >= cap) continue;
                } else {
                    int ok = 0, base = l * V;
                    for (int v = 0; v < V; v++)
                        if (owner[base + v] < 0 && cnt[base + v] < cap)
                            { ok = 1; break; }
                    if (!ok) continue;
                }
                group = l;
            }
            int64_t prio = (pa[b] + cyc_h) & PRIO_MASK;
            if (stamp[group] != cstamp) {
                stamp[group] = cstamp;
                touched[ntouched++] = group;
                best_key[group] = prio;
                best_buf[group] = b;
            } else if (prio < best_key[group]) {
                /* strict < keeps the lowest buffer id on ties */
                best_key[group] = prio;
                best_buf[group] = b;
            }
        }

        /* ---- pass 2a: forward targets (pre-pop owner/cnt snapshot) -- */
        for (int t = 0; t < ntouched; t++) {
            int g = touched[t];
            if (g >= L) continue;
            int b = best_buf[g];
            int tgt = route_tgt[b];
            if (tgt < 0) {
                int base = g * V;
                for (int v = 0; v < V; v++)
                    if (owner[base + v] < 0 && cnt[base + v] < cap)
                        { tgt = base + v; break; }
            }
            win_tgt[g] = tgt;
        }

        /* ---- pass 2b: ejections (pop + stats) ----------------------- */
        for (int t = 0; t < ntouched; t++) {
            int g = touched[t];
            if (g < L) continue;
            int b = best_buf[g];
            int node = g - L;
            int code = ring_code[b * cap + head[b]];
            int pktid = code / psize;
            int seq = code - pktid * psize;
            head[b] = (head[b] + 1) % cap;
            cnt[b]--;
            int rep = node / bn;
            flits[rep]--; total_flits--;
            prog[rep] = 1;
            int nd = node_delay[node];
            if (seq == 0)
                pk_head_arr[pktid] = cycle + nd;
            if (seq == psize - 1) {
                int birth = pk_birth[pktid];
                if (birth >= warm_end && birth < meas_end) {
                    lat_sum[rep] += (double)(cycle + nd - birth);
                    head_lat_sum[rep] += (double)(pk_head_arr[pktid] - birth);
                    measured[rep]++;
                    accepted[rep] += psize;
                }
            }
        }

        /* ---- pass 2c: forward pops + route bookkeeping -------------- */
        for (int t = 0; t < ntouched; t++) {
            int g = touched[t];
            if (g >= L) continue;
            int b = best_buf[g];
            int tgt = win_tgt[g];
            if (route_tgt[b] < 0) {          /* fresh VC allocation */
                owner[tgt] = b;
                route_tgt[b] = tgt;
            }
            if (b < nb_link) {
                head[b] = (head[b] + 1) % cap;
                cnt[b]--;
                flits[link_dst[b / V] / bn]--; total_flits--;
            } else {
                int u = b - nb_link;
                inj_seq[u]++;
                if (inj_seq[u] == psize) {
                    inj_seq[u] = 0;
                    inj_ptr[u]++;
                    pending[u / bn]--; total_pending--;
                }
            }
        }

        /* ---- pass 2d: pushes (after all pops: slots are exact) ------ */
        for (int t = 0; t < ntouched; t++) {
            int g = touched[t];
            if (g >= L) continue;
            int b = best_buf[g];
            int tgt = win_tgt[g];
            int pktid, seq, node;
            if (b < nb_link) {
                /* source head flit was popped; its code is unchanged in
                   the ring slot just vacated */
                int prev = (head[b] + cap - 1) % cap;
                int code = ring_code[b * cap + prev];
                pktid = code / psize;
                seq = code - pktid * psize;
                node = link_dst[b / V];
            } else {
                node = b - nb_link;
                pktid = inj_ptr[node];
                seq = inj_seq[node] - 1;
                if (seq < 0) { pktid -= 1; seq = psize - 1; }
            }
            int slot = (head[tgt] + cnt[tgt]) % cap;
            ring_code[tgt * cap + slot] = pktid * psize + seq;
            ring_ready[tgt * cap + slot] = cycle + link_fwd_delay[g];
            cnt[tgt]++;
            int rep = node / bn;
            flits[link_dst[tgt / V] / bn]++; total_flits++;
            prog[rep] = 1;
            if (seq == psize - 1) {          /* tail releases the route */
                route_tgt[b] = -1;
                owner[tgt] = -1;
            }
        }

        /* ---- watchdog + progress ------------------------------------ */
        for (int rp = 0; rp < B; rp++) {
            if (prog[rp]) {
                last_progress[rp] = cycle;
                prog[rp] = 0;
            } else if (cycle - last_progress[rp] > dc) {
                int born = 0;
                for (int u = rp * bn; u < (rp + 1) * bn && !born; u++)
                    if (inj_ptr[u] < inj_end[u]
                        && pk_birth[inj_ptr[u]] <= cycle)
                        born = 1;
                if (flits[rp] > 0 || born) {
                    deadlock[rp] = 1;        /* purge the replica */
                    for (int b = rp * nb_base; b < (rp + 1) * nb_base; b++)
                        cnt[b] = 0;
                    total_flits -= flits[rp];
                    flits[rp] = 0;
                    for (int u = rp * bn; u < (rp + 1) * bn; u++)
                        inj_ptr[u] = inj_end[u];
                    total_pending -= pending[rp];
                    pending[rp] = 0;
                }
                last_progress[rp] = cycle;   /* drained or just purged */
            }
        }
    }
done:
    free(best_key); free(best_buf); free(stamp); free(touched);
    free(win_tgt); free(flits); free(pending); free(prog);
    return err < 0 ? err : (int64_t)cycle;
}
"""

_CACHED: list = []          # [fn] once built, [None] if unavailable


def _cache_dir() -> str:
    """Per-user, 0700 cache dir — never a shared world-writable location
    (loading a .so from a predictable /tmp path would let another local
    user plant code)."""
    path = _env.get_str("REPRO_CKERNEL_DIR")
    if path is None:
        base = os.environ.get("XDG_CACHE_HOME",
                              os.path.join(os.path.expanduser("~"),
                                           ".cache"))
        path = os.path.join(base, "repro_simfast_ckernel")
    os.makedirs(path, mode=0o700, exist_ok=True)
    return path


def _build():
    digest = hashlib.sha256(_SOURCE.encode()).hexdigest()[:16]
    cache_dir = _cache_dir()
    so_path = os.path.join(cache_dir, f"simfast_{digest}.so")
    if not os.path.exists(so_path):
        c_path = os.path.join(cache_dir, f"simfast_{digest}.c")
        with open(c_path, "w") as f:
            f.write(_SOURCE)
        tmp = so_path + f".tmp{os.getpid()}"
        subprocess.run(["cc", "-O2", "-shared", "-fPIC", "-o", tmp, c_path],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, so_path)
    st = os.stat(so_path)
    if st.st_uid != os.getuid() or (st.st_mode & 0o022):
        raise RuntimeError(f"refusing to load {so_path}: not owned by the "
                           "current user or group/world-writable")
    lib = ctypes.CDLL(so_path)
    fn = lib.run_sim
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    f64p = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    fn.restype = ctypes.c_int64
    fn.argtypes = [i64p, i32p, i32p, i32p, i32p, i64p, i32p, i32p,
                   i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p, i32p,
                   i32p, f64p, f64p, i64p, i64p, i32p, u8p]
    return fn


def get_kernel():
    """Compiled kernel function, or None when no C compiler is usable."""
    if not _CACHED:
        try:
            _CACHED.append(_build())
        except Exception:
            _CACHED.append(None)
    return _CACHED[0]
