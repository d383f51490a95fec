"""Training driver: ``python -m repro_torch.launch.train --arch <id>
[options]``; port of ``src/repro/launch/train.py``.

It builds the model on the CUDA device (``--device cpu`` or
``device="cpu"`` for the host). Under an initialised process group (one
process a card: ``torchrun --nproc-per-node N -m repro_torch.launch.train
...`` initialises it, NCCL on the card and gloo on the host) it trains on
a ``DeviceMesh``, the host mesh (world, 1) ("data", "model") unless the
caller passes one (``--production-mesh``: 16 x 16, which needs 256 ranks):
the parameters, the optimizer state and each batch are placed by the
sharding rules (``train.state.train_state_shardings``,
``sharding.rules.batch_specs``), every rank reads the same host batch of
the step-keyed pipeline and keeps its rows, the checkpoint is restored
onto the mesh, and rank 0 logs. Without a process group it trains on the
one device. It restores the latest checkpoint under
``--ckpt-dir`` if there is one (fault-tolerant resume: the data order is a
pure function of the step counter, and the step draws no random numbers,
so a resumed run equals the uninterrupted one bit for bit), prefetches
batches on a background thread, trains with AdamW or Adafactor, and
checkpoints every ``--ckpt-interval`` steps and on SIGTERM (preemption:
the handler sets a flag, the loop saves after the step in flight and
exits). Every architecture trains (``--reduced`` for the CPU-scale
config); the data pipeline adds the VLM's patch embeddings and whisper's
frame embeddings to each batch.
"""
from __future__ import annotations

import argparse
import os
import signal
import time

import torch
import torch.distributed as dist

from ..ckpt import CheckpointManager
from ..configs import ARCH_IDS, get_config
from ..data import Prefetcher, make_pipeline
from ..models import Model, reduced
from ..models.config import ModelConfig
from ..obs.log import get_logger
from ..sharding.annotate import DEFAULT_RULES, is_device_mesh
from ..sharding.rules import distribute_batch, distribute_params
from ..train import (adafactor_init, adamw_init, init_train_state,
                     make_train_step, microbatches, place_train_state,
                     train_state_shardings)
from ..train.optimizer import OptConfig
from ..utils.device import resolve_device
from .mesh import make_device_mesh, make_host_mesh, \
    make_production_device_mesh

_LOG = get_logger("launch.train")


def build_state(model: Model, optimizer: str) -> dict:
    return init_train_state(
        model, adamw_init if optimizer == "adamw" else adafactor_init)


def to_device(batch: dict, device: torch.device) -> dict:
    """A host batch (numpy) as tensors on ``device``; token ids as int64."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if not t.is_floating_point():
            t = t.to(torch.int64)
        out[k] = t.to(device, non_blocking=True)
    return out


def _process_group_up() -> bool:
    return dist.is_available() and dist.is_initialized()


def train(cfg: ModelConfig, *, steps: int, batch: int, seq_len: int,
          lr: float = 3e-4, optimizer: str = "adamw", accum: int = 1,
          ckpt_dir: str | None = None, ckpt_interval: int = 100,
          mesh=None, log_every: int = 10, seed: int = 0,
          data_path: str | None = None, target_loss: float | None = None,
          device=None):
    """Train ``cfg`` up to step ``steps``, resuming from the latest
    checkpoint under ``ckpt_dir`` if there is one; returns (state, losses)
    with the losses of the steps this call ran.

    ``mesh`` is a ``DeviceMesh`` or its sizes (a tuple, named ("data",
    "model")); under an initialised process group None means the host
    mesh. Without a process group and a mesh the run is on one device."""
    dev = resolve_device(device)
    if mesh is None and _process_group_up():
        mesh = make_host_mesh(dev.type)
    elif mesh is not None and not is_device_mesh(mesh):
        mesh = make_device_mesh(mesh, device_type=dev.type)
    rules = DEFAULT_RULES
    rank0 = mesh is None or dist.get_rank() == 0
    # under a mesh the weights are drawn on the host and each rank moves
    # only its shards to its device (distribute_params)
    model = Model(cfg, seed=seed, device=dev if mesh is None else "cpu")
    opt_cfg = OptConfig(learning_rate=lr, warmup_steps=min(100, steps // 10),
                        decay_steps=steps)
    shardings = None
    if mesh is not None:
        distribute_params(model, mesh, rules)
        state = place_train_state(build_state(model, optimizer), mesh, rules)
        shardings = train_state_shardings(state, mesh, rules)
    else:
        state = build_state(model, optimizer)
    start_step = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, interval=ckpt_interval)
        state, restored = mgr.restore_or_init(state, shardings)
        if restored >= 0:
            start_step = restored + 1
            if rank0:
                _LOG.info(f"[train] resumed from step {restored}")
    step_fn = make_train_step(model, opt_cfg, optimizer, accum_steps=accum)

    def placed(host_batch: dict):
        """The step's batch: on the device, or under a mesh placed by the
        batch specs (with ``accum`` > 1 each microbatch of the host batch
        placed on its own)."""
        b = to_device(host_batch, dev)
        if mesh is None:
            return b
        if accum == 1:
            return distribute_batch(b, mesh, rules)
        return [distribute_batch(m, mesh, rules)
                for m in microbatches(b, accum)]

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
            state, metrics = step_fn(state, placed(host_batch))
            loss = float(metrics["loss"])
            dt = time.perf_counter() - t0
            step_times.append(dt)
            # straggler watchdog: flag steps >3x the trailing median
            med = sorted(step_times[-20:])[len(step_times[-20:]) // 2]
            if len(step_times) > 5 and dt > 3 * med:
                slow_steps += 1
                if rank0:
                    _LOG.warning(f"[train] step {i}: straggler ({dt:.2f}s "
                                 f"vs median {med:.2f}s)")
            losses.append(loss)
            if rank0 and i % log_every == 0:
                tput = batch * seq_len / dt
                _LOG.info(f"[train] step {i:5d} loss {loss:.4f} "
                          f"lr {float(metrics['lr']):.2e} "
                          f"gnorm {float(metrics['grad_norm']):.2f} "
                          f"{dt*1e3:.0f}ms ({tput:.0f} tok/s)")
            if mesh is not None:   # every rank stops after the same step
                flag = torch.tensor([float(stop["now"])], device=dev)
                dist.all_reduce(flag, op=dist.ReduceOp.MAX)
                stop["now"] = bool(flag.item())
            if mgr:
                mgr.maybe_save(i, state, force=stop["now"])
            if stop["now"]:
                what = "checkpointed at" if mgr else "stopping after"
                if rank0:
                    _LOG.warning(f"[train] SIGTERM: {what} step {i}, "
                                 f"exiting")
                break
            if target_loss is not None and loss <= target_loss:
                if rank0:
                    _LOG.info(f"[train] target loss {target_loss} reached")
                break
    finally:
        pf.close()
        signal.signal(signal.SIGTERM, old)
    wall = time.perf_counter() - t_start
    if losses and rank0:
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
    ap.add_argument("--production-mesh", action="store_true",
                    help="use the 16x16 production mesh (needs 256 ranks); "
                         "its 'model' axis splits every product the "
                         "sharding rules split (heads, MLA heads, MLP "
                         "units, experts, Mamba channels, vocabulary) and "
                         "repeats on every model rank only what they keep "
                         "whole (norms, router, MLA's wq_a / wkv_a) or "
                         "what it does not divide")
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda; 'cpu' for the host)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    dev = resolve_device(args.device)
    launched = "WORLD_SIZE" in os.environ and not _process_group_up()
    if launched:          # torchrun: one process a card
        if dev.type == "cuda":
            dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
            torch.cuda.set_device(dev)
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        mesh = (make_production_device_mesh(device_type=dev.type)
                if args.production_mesh else None)
        train(cfg, steps=args.steps, batch=args.batch, seq_len=args.seq_len,
              lr=args.lr, optimizer=args.optimizer, accum=args.accum,
              ckpt_dir=args.ckpt_dir, ckpt_interval=args.ckpt_interval,
              mesh=mesh, data_path=args.data, device=dev)
    finally:
        if launched:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
