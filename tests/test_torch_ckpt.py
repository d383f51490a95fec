"""The port's checkpoints (``repro_torch.ckpt``) and checkpointed training
(``repro_torch.launch.train``) on the CPU.

Tolerances: none. A restored leaf must equal the saved one bit for bit
(bfloat16 and float8 through their raw views), and a resumed run must equal
the uninterrupted run bit for bit: the port's copy of
``tests/test_train_loop.py::test_train_resume_continues_from_checkpoint``,
made exact because the port's train step draws no random numbers and its
data order is a function of the step.
"""
from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core  # noqa: E402,F401  (first: repro's modules need repro.core)
import repro_torch.core  # noqa: E402,F401
from repro_torch.ckpt import (CheckpointManager, latest_step,  # noqa: E402
                              restore_checkpoint, save_checkpoint)
from repro_torch.ckpt import checkpoint as ckpt_mod  # noqa: E402
from repro_torch.faults.harness import CheckpointCorruptError  # noqa: E402
from repro.ckpt import checkpoint as ref_ckpt  # noqa: E402
from repro.faults.harness import \
    CheckpointCorruptError as RefCorruptError  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def _tree(seed: int = 0) -> dict:
    g = torch.Generator().manual_seed(seed)
    tree = {
        "params": {"w": torch.nn.Parameter(torch.randn(5, 7, generator=g)),
                   "b": torch.randn(7, generator=g).to(torch.bfloat16)},
        "opt": {"m": [torch.randn(3, generator=g),
                      torch.arange(4, dtype=torch.int32)]},
        "step": 11 + seed,
        "lr": 0.25,
    }
    if hasattr(torch, "float8_e4m3fn"):
        tree["f8"] = torch.randn(6, generator=g).to(torch.float8_e4m3fn)
    return tree


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_zeros_like(v) for v in tree]
    if isinstance(tree, torch.nn.Parameter):
        return torch.nn.Parameter(torch.zeros_like(tree))
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return type(tree)(0)


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype in ckpt_mod._RAW_VIEW:
        return t.view(ckpt_mod._RAW_VIEW[t.dtype][0])
    return t


def _assert_tree_equal(a, b):
    la, sa = ckpt_mod.flatten_tree(a)
    lb, sb = ckpt_mod.flatten_tree(b)
    assert sa == sb
    for x, y in zip(la, lb):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(_bits(x), _bits(y))
        else:
            assert type(x) is type(y) and x == y


def test_round_trip_every_leaf_kind_in_place(tmp_path):
    tree = _tree()
    save_checkpoint(str(tmp_path), 11, tree)
    like = _zeros_like(tree)
    w = like["params"]["w"]
    out, step = restore_checkpoint(str(tmp_path), like)
    assert step == 11
    _assert_tree_equal(out, tree)
    # tensors are restored in place: the Parameter is the same object
    assert out["params"]["w"] is w and isinstance(w, torch.nn.Parameter)
    assert list(out) == list(like)       # dict order kept
    with open(tmp_path / "step_11" / "manifest.json") as f:
        manifest = json.load(f)
    assert {"bfloat16", "float32", "int32", "int", "float"} <= \
        set(manifest["dtypes"].values())
    assert manifest["versions"]["torch"] == torch.__version__
    assert all(len(s["sha256"]) == 64 for s in manifest["shards"])


def test_restore_casts_into_the_targets_dtype(tmp_path):
    save_checkpoint(str(tmp_path), 0, {"x": torch.arange(6.0)})
    like = {"x": torch.zeros(6, dtype=torch.float64)}
    out, _ = restore_checkpoint(str(tmp_path), like)
    assert out["x"].dtype == torch.float64
    assert torch.equal(out["x"], torch.arange(6.0, dtype=torch.float64))


def test_shards_split_at_the_shard_size(tmp_path, monkeypatch):
    monkeypatch.setattr(ckpt_mod, "_SHARD_BYTES", 40)   # one 10-float leaf
    tree = {f"t{i}": torch.full((10,), float(i)) for i in range(5)}
    save_checkpoint(str(tmp_path), 3, tree)
    names = sorted(os.listdir(tmp_path / "step_3"))
    assert names == ["manifest.json"] + [f"shard_{i}.npz" for i in range(5)]
    out, _ = restore_checkpoint(str(tmp_path), _zeros_like(tree))
    _assert_tree_equal(out, tree)


def test_retention_and_latest(tmp_path):
    d = str(tmp_path)
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, _tree(s), keep_last=3)
    assert sorted(os.listdir(d)) == ["LATEST", "step_3", "step_4", "step_5"]
    assert latest_step(d) == 5
    out, step = restore_checkpoint(d, _zeros_like(_tree()))
    assert step == 5 and out["step"] == 16
    # LATEST naming a deleted step falls back to the newest on disk
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("9")
    assert latest_step(d) == 5


def test_manager_interval_and_restore_or_init(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), interval=2)
    tree = _tree()
    assert mgr.restore_or_init(tree) == (tree, -1)
    assert mgr.maybe_save(0, tree) is None
    assert mgr.maybe_save(1, tree) is None
    assert mgr.maybe_save(2, tree) is not None
    assert mgr.maybe_save(3, tree, force=True) is not None
    _, step = mgr.restore_or_init(_zeros_like(tree))
    assert step == 3


@pytest.mark.parametrize("change", ["key", "leaf_count", "kind", "shape"])
def test_structure_mismatch_raises(tmp_path, change):
    tree = {"a": torch.zeros(3), "b": {"c": torch.zeros(2)}, "step": 1}
    save_checkpoint(str(tmp_path), 1, tree)
    like = {"a": torch.zeros(3), "b": {"c": torch.zeros(2)}, "step": 0}
    if change == "key":
        like["b"] = {"d": torch.zeros(2)}
    elif change == "leaf_count":
        like["e"] = torch.zeros(1)
    elif change == "kind":
        like["step"] = torch.zeros(())
    else:
        like["a"] = torch.zeros(4)
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path), like, step=1)


def test_corrupt_shard_falls_back_and_explicit_step_raises(tmp_path, capsys):
    d = str(tmp_path)
    save_checkpoint(d, 1, _tree(1))
    save_checkpoint(d, 2, _tree(2))
    shard = os.path.join(d, "step_2", "shard_0.npz")
    with open(shard, "r+b") as f:
        f.seek(100)
        byte = f.read(1)
        f.seek(100)
        f.write(bytes([byte[0] ^ 0xFF]))
    like = _zeros_like(_tree())
    out, step = restore_checkpoint(d, like)
    assert step == 1
    _assert_tree_equal(out, _tree(1))
    assert "step_2 rejected" in capsys.readouterr().out
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(d, _zeros_like(_tree()), step=2)


def test_version_stamp_mismatch_warns_and_restores(tmp_path, capsys):
    d = str(tmp_path)
    save_checkpoint(d, 4, _tree())
    path = os.path.join(d, "step_4", "manifest.json")
    with open(path) as f:
        manifest = json.load(f)
    manifest["versions"]["torch"] = "0.0.1"
    with open(path, "w") as f:
        json.dump(manifest, f)
    out, step = restore_checkpoint(d, _zeros_like(_tree()))
    assert step == 4
    _assert_tree_equal(out, _tree())
    assert "torch=0.0.1" in capsys.readouterr().out


def test_save_is_traced(tmp_path):
    from repro_torch.obs import trace as tr

    was = tr.tracing_enabled()
    tr.enable_tracing(clear=True)
    try:
        save_checkpoint(str(tmp_path), 7, {"x": torch.zeros(2)})
        names = [e["name"] for e in tr.TRACER.to_dicts()]
    finally:
        if not was:
            tr.disable_tracing()
    assert "ckpt.save" in names


# ---------------------------------------------------------------------------
# the same trees through the reference's checkpoints
# ---------------------------------------------------------------------------

def _np_tree(seed: int = 0) -> dict:
    """A numpy-valued tree for the reference: f32, bf16, int32 and int64
    leaves in nested dicts (inserted out of key order) and a list."""
    import ml_dtypes

    rng = np.random.default_rng(seed)
    return {
        "params": {"w": rng.standard_normal((5, 7)).astype(np.float32),
                   "b": rng.standard_normal(7).astype(ml_dtypes.bfloat16)},
        "opt": {"m": [rng.standard_normal(3).astype(np.float32),
                      np.arange(4, dtype=np.int32) + seed],
                "count": np.asarray(seed, np.int64)},
        "emb": rng.standard_normal((3, 2)).astype(np.float32),
    }


def _as_torch(tree):
    """The same tree as the port's tensors, bf16 through its raw bits."""
    if isinstance(tree, dict):
        return {k: _as_torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_as_torch(v) for v in tree]
    if tree.dtype.name == "bfloat16":
        return torch.from_numpy(tree.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(tree))


def _np_zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _np_zeros_like(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np_zeros_like(v) for v in tree]
    return np.zeros_like(tree)


def _raw(x) -> np.ndarray:
    """A leaf's stored bits: bf16 as uint16, everything else as is."""
    if isinstance(x, torch.Tensor):
        x = _bits(x).numpy()
        return x.view(np.uint16) if x.dtype == np.int16 else x
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.name == "bfloat16" else x


def _assert_same_values(port_tree, ref_tree):
    import jax

    ref = jax.tree_util.tree_leaves(ref_tree)
    port, _ = ckpt_mod.flatten_tree(port_tree)
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        p, r = _raw(p), _raw(r)
        assert p.dtype == r.dtype and np.array_equal(p, r)


def _save_both(tmp_path, steps, keep_last=3, seed=None):
    port, ref = str(tmp_path / "port"), str(tmp_path / "ref")
    for s in steps:
        tree = _np_tree(s if seed is None else seed)
        ref_ckpt.save_checkpoint(ref, s, tree, keep_last=keep_last)
        save_checkpoint(port, s, _as_torch(tree), keep_last=keep_last)
    return port, ref


def _manifest(d: str, step: int) -> dict:
    with open(os.path.join(d, f"step_{step}", "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("shard_bytes", [None, 30])
def test_layout_equals_the_references(tmp_path, monkeypatch, shard_bytes):
    """The same tree saved by both packages: the same leaf count, leaf
    dtypes, shard files and their keys, and the same stored bits in every
    shard (bf16 as its uint16 view in both). Only the structure string and
    the version stamp are each package's own."""
    if shard_bytes is not None:
        monkeypatch.setattr(ckpt_mod, "_SHARD_BYTES", shard_bytes)
        monkeypatch.setattr(ref_ckpt, "_SHARD_BYTES", shard_bytes)
    port, ref = _save_both(tmp_path, [7])
    mp, mr = _manifest(port, 7), _manifest(ref, 7)
    assert set(mp) == set(mr)
    for key in ("step", "n_leaves", "dtypes"):
        assert mp[key] == mr[key], key
    assert [(s["file"], s["keys"]) for s in mp["shards"]] == \
        [(s["file"], s["keys"]) for s in mr["shards"]]
    assert len(mp["shards"]) == (1 if shard_bytes is None else 3)
    assert sorted(os.listdir(os.path.join(port, "step_7"))) == \
        sorted(os.listdir(os.path.join(ref, "step_7")))
    for sh in mr["shards"]:
        with np.load(os.path.join(port, "step_7", sh["file"])) as zp, \
                np.load(os.path.join(ref, "step_7", sh["file"])) as zr:
            assert sorted(zp.files) == sorted(zr.files)
            for k in zr.files:
                assert zp[k].dtype == zr[k].dtype
                assert np.array_equal(zp[k], zr[k]), k
    restored_ref, step_ref = ref_ckpt.restore_checkpoint(
        ref, _np_zeros_like(_np_tree()))
    restored, step = restore_checkpoint(port, _as_torch(
        _np_zeros_like(_np_tree())))
    assert step == step_ref == 7
    _assert_same_values(restored, restored_ref)
    _assert_same_values(restored, _np_tree(7))


@pytest.mark.parametrize("keep_last", [1, 2, 3])
def test_retention_latest_and_fallback_equal_the_references(tmp_path,
                                                            keep_last):
    """Saves of steps 1-5 on both packages keep the same step directories
    and LATEST; once the newest step's shard is corrupted, both restore the
    same older step (or both fail), and both refuse the corrupt step when
    it is asked for."""
    port, ref = _save_both(tmp_path, [1, 2, 3, 4, 5], keep_last=keep_last)
    assert sorted(os.listdir(port)) == sorted(os.listdir(ref))
    for d in (port, ref):
        with open(os.path.join(d, "LATEST")) as f:
            assert f.read() == "5"
    assert latest_step(port) == ref_ckpt.latest_step(ref) == 5
    for d in (port, ref):
        shard = os.path.join(d, "step_5", "shard_0.npz")
        with open(shard, "r+b") as f:
            f.seek(100)
            byte = f.read(1)
            f.seek(100)
            f.write(bytes([byte[0] ^ 0xFF]))
    like_ref, like = _np_zeros_like(_np_tree()), _as_torch(
        _np_zeros_like(_np_tree()))
    if keep_last == 1:
        with pytest.raises(RefCorruptError):
            ref_ckpt.restore_checkpoint(ref, like_ref)
        with pytest.raises(CheckpointCorruptError):
            restore_checkpoint(port, like)
    else:
        out_ref, step_ref = ref_ckpt.restore_checkpoint(ref, like_ref)
        out, step = restore_checkpoint(port, like)
        assert step == step_ref == 4
        _assert_same_values(out, out_ref)
    with pytest.raises(RefCorruptError):
        ref_ckpt.restore_checkpoint(ref, _np_zeros_like(_np_tree()), step=5)
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(port, _as_torch(_np_zeros_like(_np_tree())),
                           step=5)
    # LATEST naming a deleted step: both fall back to the newest on disk
    for d in (port, ref):
        with open(os.path.join(d, "LATEST"), "w") as f:
            f.write("9")
    assert latest_step(port) == ref_ckpt.latest_step(ref) == 5


def test_manager_schedule_equals_the_references(tmp_path):
    """Both managers save at the same steps (every ``interval``, and when
    forced), keep the same directories and resume at the same step."""
    port = CheckpointManager(str(tmp_path / "port"), interval=3, keep_last=2)
    ref = ref_ckpt.CheckpointManager(str(tmp_path / "ref"), interval=3,
                                     keep_last=2)
    tree = _np_tree(1)
    assert ref.restore_or_init(tree)[1] == port.restore_or_init(
        _as_torch(tree))[1] == -1
    for s in range(8):
        force = s == 7
        saved_ref = ref.maybe_save(s, tree, force=force)
        saved = port.maybe_save(s, _as_torch(tree), force=force)
        assert (saved is None) == (saved_ref is None), s
    assert sorted(os.listdir(port.directory)) == \
        sorted(os.listdir(ref.directory)) == ["LATEST", "step_6", "step_7"]
    out_ref, step_ref = ref.restore_or_init(_np_zeros_like(tree))
    out, step = port.restore_or_init(_as_torch(_np_zeros_like(tree)))
    assert step == step_ref == 7
    _assert_same_values(out, out_ref)


# ---------------------------------------------------------------------------
# checkpointed training
# ---------------------------------------------------------------------------

def _cfg():
    from repro_torch.configs import get_config
    from repro_torch.models import reduced

    return reduced(get_config("falcon-mamba-7b"))


_KW = dict(steps=6, batch=2, seq_len=32, lr=5e-3, log_every=100,
           device="cpu")


def _assert_state_equal(a: dict, b: dict):
    assert a["step"] == b["step"]
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for m in a["opt"]:
        for k in a["opt"][m]:
            assert torch.equal(a["opt"][m][k], b["opt"][m][k]), (m, k)


def test_resumed_training_equals_uninterrupted_bit_for_bit(tmp_path,
                                                           monkeypatch):
    """6 steps == 3 steps, a SIGTERM checkpoint, and a resume for 3 more:
    losses, parameters and AdamW moments bit-equal."""
    import repro_torch.launch.train as T

    cfg = _cfg()
    full_state, full_losses = T.train(cfg, **_KW)

    real = T.make_train_step

    def preempted_after_three(*args, **kw):
        step_fn = real(*args, **kw)
        calls = {"n": 0}

        def step(state, batch):
            out = step_fn(state, batch)
            calls["n"] += 1
            if calls["n"] == 3:
                signal.raise_signal(signal.SIGTERM)
            return out
        return step

    d = str(tmp_path / "ck")
    monkeypatch.setattr(T, "make_train_step", preempted_after_three)
    _, first = T.train(cfg, ckpt_dir=d, ckpt_interval=100, **_KW)
    monkeypatch.setattr(T, "make_train_step", real)
    assert len(first) == 3 and latest_step(d) == 2
    state, rest = T.train(cfg, ckpt_dir=d, ckpt_interval=100, **_KW)
    assert first + rest == full_losses
    _assert_state_equal(state, full_state)


def test_train_checkpoints_periodically_and_resumes_past_them(tmp_path):
    from repro_torch.launch.train import train

    cfg = _cfg()
    d = str(tmp_path / "ck")
    state, losses = train(cfg, ckpt_dir=d, ckpt_interval=2, **_KW)
    assert len(losses) == 6 and state["step"] == 6
    assert latest_step(d) == 4
    # a rerun resumes after step 4 and runs only step 5, with the same loss
    state2, losses2 = train(cfg, ckpt_dir=d, ckpt_interval=2, **_KW)
    assert losses2 == losses[5:]
    _assert_state_equal(state2, state)


def test_sigterm_checkpoints_exits_zero_and_resumes(tmp_path):
    """``python -m repro_torch.launch.train --ckpt-dir`` under SIGTERM:
    it checkpoints the step in flight, exits 0, and a restart resumes at
    the next step."""
    d = str(tmp_path / "ck")
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.abspath(SRC) + os.pathsep
                         + env.get("PYTHONPATH", ""))
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
            "falcon-mamba-7b", "--reduced", "--device", "cpu", "--batch",
            "2", "--seq-len", "32", "--ckpt-dir", d, "--ckpt-interval", "2"]
    proc = subprocess.Popen(base + ["--steps", "100000"], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    try:
        deadline = time.monotonic() + 120
        while latest_step(d) is None if os.path.isdir(d) else True:
            assert proc.poll() is None, proc.stdout.read()
            assert time.monotonic() < deadline
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, out
    k = latest_step(d)
    assert f"SIGTERM: checkpointed at step {k}, exiting" in out
    res = subprocess.run(base + ["--steps", str(k + 2)], env=env, text=True,
                         capture_output=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert f"resumed from step {k}" in res.stdout
    assert "done: 1 steps" in res.stdout
