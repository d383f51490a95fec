"""Serving: token-by-token generation with KV/state caches;
``python -m repro_torch.launch.serve --arch <id>``, port of
``src/repro/launch/serve.py`` on one device.

It runs on the CUDA device (``--device cpu`` for the host; ``--reduced``
for the CPU-scale config). The prompt is fed through the decode step one
token at a time, exercising the cache as serving would (a fused prefill is
``Model.prefill``); then each new token is the argmax of the last logits,
or, with ``--temperature``, a draw from the tempered softmax by a
``torch.Generator`` seeded with ``seed`` (not ``jax.random``'s stream). The
decode step runs eagerly: the reference's ``jax.jit`` is XLA's compile
step, and the reference's mesh has no counterpart on one device.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import ARCH_IDS, get_config
from ..models import Model, reduced
from ..obs.log import get_logger
from ..utils.device import resolve_device

_LOG = get_logger("launch.serve")


def generate(model: Model, prompts: np.ndarray, max_new: int,
             temperature: float = 0.0, seed: int = 0,
             params=None) -> np.ndarray:
    """Greedy/temperature decode of a batch of fixed-length prompts
    ([B, prompt_len] ints) on the model's device; returns the new tokens
    [B, max_new]."""
    dev = model.device
    b, prompt_len = prompts.shape
    params = model.params() if params is None else params
    cache = model.init_cache(b, prompt_len + max_new)
    tokens = torch.as_tensor(np.asarray(prompts), dtype=torch.int64,
                             device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    out = []
    logits = None
    for t in range(prompt_len):
        logits, cache = model.decode_step(cache, tokens[:, t:t + 1], t,
                                          params)
    for t in range(max_new):
        lg = logits[:, -1].to(torch.float32)
        if temperature > 0:
            probs = torch.softmax(lg / temperature, dim=-1)
            cur = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            cur = torch.argmax(lg, dim=-1)
        out.append(cur)
        logits, cache = model.decode_step(cache, cur[:, None],
                                          prompt_len + t, params)
    if not out:
        return np.zeros((b, 0), np.int64)
    return torch.stack(out, dim=1).cpu().numpy()


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
    model = Model(cfg, seed=0, device=dev)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.perf_counter()
    completions = generate(model, prompts, args.max_new, args.temperature)
    dt = time.perf_counter() - t0
    n_tok = args.batch * (args.prompt_len + args.max_new)
    _LOG.info(f"[serve] {args.arch} on {dev}: {args.batch} seqs x "
              f"({args.prompt_len} prompt + {args.max_new} new) in "
              f"{dt:.1f}s ({n_tok / dt:.1f} tok/s)")
    _LOG.info(f"[serve] sample completion token ids: {completions[0][:16]}")
    return completions


if __name__ == "__main__":
    main()
