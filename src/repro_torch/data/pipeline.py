# Copy of src/repro/data/pipeline.py (numpy only).
"""Token data pipeline: step-indexed (seekable) sources + background
prefetch.

Fault-tolerance contract: a source is a pure function of the step index
(``batch_at(step)``), so training resumed from a checkpoint at step k
reproduces the exact data order without replaying the stream — no data-loader
state needs checkpointing beyond the step counter itself.
"""
from __future__ import annotations

import queue
import threading

import numpy as np


class SyntheticTokens:
    """Deterministic synthetic LM batches: tokens ~ Zipf-ish categorical,
    labels = tokens shifted left (next-token prediction)."""

    def __init__(self, vocab_size: int, batch: int, seq_len: int,
                 seed: int = 0, extra_shapes: dict | None = None):
        self.vocab = vocab_size
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.extra_shapes = extra_shapes or {}

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        # zipf-flavored distribution capped at vocab
        raw = rng.zipf(1.3, size=(self.batch, self.seq + 1))
        tokens = (raw % self.vocab).astype(np.int32)
        out = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
        for name, (shape, dtype) in self.extra_shapes.items():
            out[name] = rng.normal(0, 1, (self.batch, *shape)).astype(dtype)
        return out


class FileTokens:
    """Flat binary token file (uint16/uint32) read as strided windows; the
    window for a given step is a pure function of (step, batch index)."""

    def __init__(self, path: str, batch: int, seq_len: int,
                 dtype=np.uint16, seed: int = 0):
        self.data = np.memmap(path, dtype=dtype, mode="r")
        self.batch = batch
        self.seq = seq_len
        self.seed = seed
        self.n_windows = max(1, (len(self.data) - 1) // seq_len)

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed, step))
        idx = rng.integers(0, self.n_windows, self.batch)
        starts = idx * self.seq
        tok = np.stack([self.data[s:s + self.seq + 1] for s in starts])
        tok = tok.astype(np.int32)
        return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}


class Prefetcher:
    """Background-thread prefetch of ``batch_at(step)`` results (overlap host
    data generation with device compute)."""

    def __init__(self, source, start_step: int = 0, depth: int = 2):
        self.source = source
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._next = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        step = self._next
        while not self._stop.is_set():
            try:
                self._q.put((step, self.source.batch_at(step)), timeout=0.2)
                step += 1
            except queue.Full:
                continue

    def get(self) -> tuple[int, dict]:
        return self._q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def make_pipeline(cfg, batch: int, seq_len: int, seed: int = 0,
                  path: str | None = None):
    """Source for a model config: adds the stub-frontend extras (VLM patches
    / audio frames) the model expects."""
    extra = {}
    if cfg.family == "vlm":
        seq_len = seq_len - cfg.n_image_tokens
        extra["patches"] = ((cfg.n_image_tokens, cfg.d_model), np.float32)
    if cfg.family == "encdec":
        extra["frames"] = ((cfg.n_audio_frames, cfg.d_model), np.float32)
    if path:
        return FileTokens(path, batch, seq_len, seed=seed)
    return SyntheticTokens(cfg.vocab_size, batch, seq_len, seed=seed,
                           extra_shapes=extra)
