"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[options]``; port of ``src/repro/launch/train.py`` on one device.

It builds the model on the CUDA device (``--device cpu`` or
``device="cpu"`` for the host), restores the latest checkpoint under
``--ckpt-dir`` if there is one (fault-tolerant resume: the data order is a
pure function of the step counter, and the step draws no random numbers,
so a resumed run equals the uninterrupted one bit for bit), prefetches
batches on a background thread, trains with AdamW or Adafactor, and
checkpoints every ``--ckpt-interval`` steps and on SIGTERM (preemption:
the handler sets a flag, the loop saves after the step in flight and
exits). The reference's mesh arguments (ROADMAP Queue A 12) are not
ported. The family the port's ``Model`` implements is ``ssm``
(falcon-mamba-7b; ``--reduced`` for the CPU-scale config).
"""
from __future__ import annotations

import argparse
import signal
import time

import torch

from ..ckpt import CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..data import Prefetcher, make_pipeline
from ..models import Model, reduced
from ..models.config import ModelConfig
from ..obs.log import get_logger
from ..train import adafactor_init, adamw_init, make_train_step
from ..train.optimizer import OptConfig
from ..utils.device import resolve_device

_LOG = get_logger("launch.train")


def build_state(model: Model, optimizer: str) -> dict:
    params = dict(model.named_parameters())
    opt = (adamw_init if optimizer == "adamw" else adafactor_init)(
        {k: p.detach() for k, p in params.items()})
    return {"params": params, "opt": opt, "step": 0}


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy) as tensors on ``device``; token ids as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device, non_blocking=True)
    return out


def train(cfg: ModelConfig, *, steps: int, batch: int, seq_len: int,
          lr: float = 3e-4, optimizer: str = "adamw", accum: int = 1,
          ckpt_dir: str | None = None, ckpt_interval: int = 100,
          log_every: int = 10, seed: int = 0, data_path: str | None = None,
          target_loss: float | None = None, device=None):
    """Train ``cfg`` up to step ``steps``, resuming from the latest
    checkpoint under ``ckpt_dir`` if there is one; returns (state, losses)
    with the losses of the steps this call ran."""
    dev = resolve_device(device)
    model = Model(cfg, seed=seed, device=dev)
    opt_cfg = OptConfig(learning_rate=lr, warmup_steps=min(100, steps // 10),
                        decay_steps=steps)
    state = build_state(model, optimizer)
    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, interval=ckpt_interval)
        state, restored = mgr.restore_or_init(state)
        if restored >= 0:
            start_step = restored + 1
            _LOG.info(f"[train] resumed from step {restored}")
    step_fn = make_train_step(model, opt_cfg, optimizer, accum_steps=accum)
    source = make_pipeline(cfg, batch, seq_len, seed=seed, path=data_path)
    pf = Prefetcher(source, start_step=start_step)

    stop = {"now": False}

    def on_sigterm(signum, frame):   # preemption: checkpoint + exit
        stop["now"] = True

    old = signal.signal(signal.SIGTERM, on_sigterm)
    losses = []
    t_start = time.perf_counter()
    slow_steps = 0
    step_times = []
    try:
        for i in range(start_step, steps):
            step_idx, host_batch = pf.get()
            assert step_idx == i, (step_idx, i)
            t0 = time.perf_counter()
            state, metrics = step_fn(state, to_device(host_batch, dev))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            step_times.append(dt)
            # straggler watchdog: flag steps >3x the trailing median
            med = sorted(step_times[-20:])[len(step_times[-20:]) // 2]
            if len(step_times) > 5 and dt > 3 * med:
                slow_steps += 1
                _LOG.warning(f"[train] step {i}: straggler ({dt:.2f}s vs "
                             f"median {med:.2f}s)")
            losses.append(loss)
            if i % log_every == 0:
                tput = batch * seq_len / dt
                _LOG.info(f"[train] step {i:5d} loss {loss:.4f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"gnorm {float(metrics['grad_norm']):.2f} "
                          f"{dt*1e3:.0f}ms ({tput:.0f} tok/s)")
            if mgr:
                mgr.maybe_save(i, state, force=stop["now"])
            if stop["now"]:
                what = "checkpointed at" if mgr else "stopping after"
                _LOG.warning(f"[train] SIGTERM: {what} step {i}, exiting")
                break
            if target_loss is not None and loss <= target_loss:
                _LOG.info(f"[train] target loss {target_loss} reached")
                break
    finally:
        pf.close()
        signal.signal(signal.SIGTERM, old)
    wall = time.perf_counter() - t_start
    if losses:
        _LOG.info(f"[train] done: {len(losses)} steps in {wall:.1f}s, "
                  f"loss {losses[0]:.3f} -> {losses[-1]:.3f}, "
                  f"{slow_steps} straggler steps flagged")
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw",
                    choices=["adamw", "adafactor"])
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-interval", type=int, default=100)
    ap.add_argument("--reduced", action="store_true",
                    help="use the CPU-scale reduced config")
    ap.add_argument("--data", default=None, help="binary token file")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the host)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
          lr=args.lr, optimizer=args.optimizer, accum=args.accum,
          ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval,
          data_path=args.data, device=args.device)


if __name__ == "__main__":
    main()
