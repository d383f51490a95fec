"""The yardstick of the kernels' roofline shares: the card's peaks and the
operations and bytes that a call's inputs need, whatever implements it.

Peaks are NVIDIA's data sheet for the H100 SXM at its full 700 W power
limit (the result line records the card's limit beside them): 3.35 TB/s of
HBM, and one float32 instruction a lane a clock on 132 SMs x 128 lanes at
the 1980 MHz maximum SM clock. A (min, +) candidate is one FADD and one
FMNMX, so it costs two instructions. Bytes count each input read once and
each output written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
SMS, FP32_LANES, MAX_SM_CLOCK_HZ = 132, 128, 1.98e9
FP32_INSTR_PER_S = SMS * FP32_LANES * MAX_SM_CLOCK_HZ


def _bound(nbytes: float, instructions: float) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = instructions / FP32_INSTR_PER_S
    return {"bytes": nbytes, "instructions": instructions,
            "seconds": max(t_bytes, t_ops),
            "by": "bytes" if t_bytes >= t_ops else "operations"}


def load_propagation(rows: int, n: int) -> dict:
    """Load propagation over ``rows`` routing tables of n x n: the int32
    next-hop table and the float32 initial load in, the float32 summed load
    W and edge flows out (16 bytes an entry); at least one add an entry for
    a hop and one for the flow contraction."""
    entries = rows * n * n
    return _bound(16.0 * entries, 2.0 * entries)


def minplus_selection(rows: int, n: int, max_degree: int) -> dict:
    """The lowest-ID next-hop selection as one (min, +) product a row:
    [n, n] edge costs x [n, n] distance scores -> [n, n], float32 (12 bytes
    an entry). The edge costs are finite only at a chiplet's links, at most
    ``max_degree`` a row, so an (u, d) entry needs at most ``max_degree``
    candidates, not n. At two instructions a candidate against 12 bytes an
    entry the bytes bound the product for any max_degree under 60, so
    counting the cap and not each row's links changes no share."""
    return _bound(12.0 * rows * n * n, 2.0 * rows * n * n * max_degree)
