"""Serving: token-by-token generation with KV/state caches;
``python -m repro_torch.launch.serve --arch <id>``, port of
``src/repro/launch/serve.py``.

It runs on the CUDA device (``--device cpu`` for the host; ``--reduced``
for the CPU-scale config). The prompt is fed through the decode step one
token at a time, exercising the cache as serving would (a fused prefill is
``Model.prefill``); then each new token is the argmax of the last logits,
or, with ``--temperature``, a draw from the tempered softmax by a
``torch.Generator`` seeded with ``seed`` (not ``jax.random``'s stream). The
decode step runs eagerly: the reference's ``jax.jit`` is XLA's compile
step.

On a ``torch.distributed`` ``DeviceMesh`` ("data", "model"; one process a
card) ``generate(..., mesh=mesh, rules=...)`` places the parameters by
``param_specs``, the caches by ``cache_specs`` and each step's tokens by
``batch_specs`` under ``rules`` (``DEFAULT_RULES``, ``SERVING_RULES`` or
``LONG_CONTEXT_RULES``, the reference's three), and runs the decode step
once a rank. Under ``torchrun`` ``main`` serves on the host mesh (world,
1) under ``DEFAULT_RULES`` with the weights drawn on the host, as the
reference's launcher runs ``generate`` inside its host mesh.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..models import Model, reduced
from ..obs.log import get_logger
from ..sharding import spmd as SP
from ..sharding.annotate import DEFAULT_RULES, NamedSharding
from ..sharding.rules import batch_specs, distribute_params
from ..utils.device import resolve_device
from .mesh import make_host_mesh

_LOG = get_logger("launch.serve")


@torch.no_grad()
def generate(model: Model, prompts: np.ndarray, max_new: int,
             temperature: float = 0.0, seed: int = 0, params=None, *,
             mesh=None, rules=DEFAULT_RULES) -> np.ndarray:
    """Greedy/temperature decode of a batch of fixed-length prompts
    ([B, prompt_len] ints) on the model's device; returns the new tokens
    [B, max_new].

    ``mesh``: a ``DeviceMesh`` (or None: the model's own, if its
    parameters are placed on one). A model not yet placed is placed there
    by ``distribute_params(model, mesh, rules)``; every rank passes the
    same host prompts and gets every row's tokens back. Each rank decodes
    its rows (``Model.decode_step`` on its shards); a greedy token is the
    argmax over the ranks' runs of a vocabulary split over "model"
    (``sharding.spmd.argmax_over_model``), and a temperature draw comes from
    a generator seeded with ``seed`` and this rank's row shard, over the
    logits gathered whole, so every model rank of a data group draws the
    same token (only determinism is held, as on one device)."""
    mesh = model._mesh() if mesh is None else mesh
    if mesh is not None and model._mesh() is None:
        distribute_params(model, mesh, rules)
    elif mesh is not None and model._mesh() != mesh:
        raise ValueError("the model's parameters are placed on another mesh")
    dev = model.device
    b, prompt_len = prompts.shape
    params = model.params() if params is None else params
    host = torch.as_tensor(np.asarray(prompts), dtype=torch.int64)
    if mesh is None:
        ctx, tokens = contextlib.nullcontext(), host.to(dev)
        cache = model.init_cache(b, prompt_len + max_new)

        def step(cache, tokens, pos):
            return model.decode_step(cache, tokens, pos, params)[0], False
    else:
        # each rank's rows, its run of a vocabulary split over "model"
        ctx = SP.spmd(mesh, b, rules)
        spec = batch_specs({"tokens": host[:, :1]}, mesh, rules)["tokens"]
        tokens = SP.place(host, NamedSharding(mesh, spec))
        cache = model.init_cache(b, prompt_len + max_new, rules=rules)

        def step(cache, tokens, pos):
            return model._decode(cache, tokens, pos, params)

    out = []
    with ctx:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + (SP.row_shard_index() << 32))
        local = SP.local_batch(tokens)
        logits, split = None, False
        for t in range(prompt_len):
            logits, split = step(cache, local[:, t:t + 1], t)
        for t in range(max_new):
            lg = logits[:, -1].to(torch.float32)
            if temperature > 0:
                if split:
                    lg = SP.gather_over_model(lg, -1)
                probs = torch.softmax(lg / temperature, dim=-1)
                cur = torch.multinomial(probs, 1, generator=gen)[:, 0]
            else:
                cur = SP.argmax_over_model(lg, split)
            out.append(cur)
            logits, split = step(cache, cur[:, None], prompt_len + t)
        if not out:
            return np.zeros((b, 0), np.int64)
        new = torch.stack(out, dim=1)
        if mesh is not None:
            new = SP.full_value(SP.as_batch_rows(new))
    return new.cpu().numpy()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="torch device (default cuda; 'cpu' for the host)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.family == "encdec":
        raise SystemExit("serve demo targets decoder-only archs; whisper "
                         "decode is exercised by the dry-run and smoke tests")
    dev = resolve_device(args.device)
    launched = "WORLD_SIZE" in os.environ and not dist.is_initialized()
    if launched:          # torchrun: one process a card
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = make_host_mesh(dev.type) if dist.is_initialized() else None
        rank0 = mesh is None or dist.get_rank() == 0
        # under a mesh the weights are drawn on the host and each rank
        # moves only its shards to its device (distribute_params)
        model = Model(cfg, seed=0, device=dev if mesh is None else "cpu")
        rng = np.random.default_rng(0)
        prompts = rng.integers(0, cfg.vocab_size,
                               (args.batch, args.prompt_len))
        t0 = time.perf_counter()
        completions = generate(model, prompts, args.max_new,
                               args.temperature, mesh=mesh)
        dt = time.perf_counter() - t0
        n_tok = args.batch * (args.prompt_len + args.max_new)
        where = dev if mesh is None else (
            f"a {tuple(mesh.shape)} {dev.type} mesh "
            f"{tuple(mesh.mesh_dim_names)}")
        if rank0:
            _LOG.info(f"[serve] {args.arch} on {where}: {args.batch} seqs x "
                      f"({args.prompt_len} prompt + {args.max_new} new) in "
                      f"{dt:.1f}s ({n_tok / dt:.1f} tok/s)")
            _LOG.info(f"[serve] sample completion token ids: "
                      f"{completions[0][:16]}")
        return completions
    finally:
        if launched:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
