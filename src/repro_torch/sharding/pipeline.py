"""GPipe-style pipeline parallelism over a "stage" mesh dimension; port of
``src/repro/sharding/pipeline.py`` on ``torch.distributed``.

* layers are split into S contiguous stages; each rank of the "stage"
  dimension of a ``DeviceMesh`` runs one stage with its own slice of the
  parameters;
* microbatches stream through the classic GPipe schedule: at tick t,
  stage s processes microbatch t-s (if 0 <= t-s < M) and sends its
  activation to stage s+1;
* bubble fraction = (S-1)/(M+S-1), amortized by more microbatches.

The reference's ring ``ppermute`` is a ``batch_isend_irecv`` to the next
stage and from the previous one, and its final ``psum`` broadcast of the
last stage's outputs an ``all_reduce``. A mesh of one stage (a
``MeshShape`` will do) runs the plain loop with no process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .annotate import as_mesh_shape


def _take(tree, i: int):
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]


def pipeline_apply(stage_fn, mesh, axis: str = "stage"):
    """Build a pipelined apply: (stage_params, microbatches) -> outputs.

    stage_params: a tensor, or a dict of them, with a leading ``S`` axis
                  (one slice per stage; each rank takes its own).
    microbatches: [M, mb, ...]; every stage receives the full stream but
                  only stage 0 injects it.
    Returns [M, mb, ...] outputs on every stage (the last stage's,
    broadcast back).
    """
    n_stages = as_mesh_shape(mesh).shape[axis]

    def plain(params, xs):
        p = _take(params, 0)
        return torch.stack([stage_fn(p, x) for x in xs])

    if n_stages == 1:
        return plain

    def apply(params, xs):
        group = mesh.get_group(axis)
        stage = mesh.get_local_rank(axis)
        nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
        prv = dist.get_global_rank(group, (stage - 1) % n_stages)
        params = _take(params, stage)
        m = xs.shape[0]
        inflight = torch.zeros_like(xs[0])
        outputs = torch.zeros_like(xs)
        for t in range(m + n_stages - 1):
            active = 0 <= t - stage < m
            x_in = xs[min(max(t, 0), m - 1)] if stage == 0 else inflight
            y = stage_fn(params, x_in)
            if not active:
                y = torch.zeros_like(y)
            elif stage == n_stages - 1:
                outputs[t - stage] = y
            # hand activations downstream (ring; last -> first unused)
            recv = torch.empty_like(y)
            reqs = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                dist.P2POp(dist.irecv, recv, prv, group)])
            for r in reqs:
                r.wait()
            inflight = recv
        # outputs are zero off the last stage, so a sum is a broadcast
        dist.all_reduce(outputs, group=group)
        return outputs

    return apply


def split_stages(stacked_params, n_stages: int):
    """Reshape layer-stacked params [L, ...] into [S, L/S, ...] stage
    slices."""
    def one(p):
        l = p.shape[0]
        if l % n_stages:
            raise ValueError(f"{l} layers do not split into {n_stages} "
                             f"stages")
        return p.reshape(n_stages, l // n_stages, *p.shape[1:])
    if isinstance(stacked_params, dict):
        return {k: split_stages(v, n_stages)
                for k, v in stacked_params.items()}
    return one(stacked_params)


__all__ = ["pipeline_apply", "split_stages"]
