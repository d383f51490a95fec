"""The port's training stack (``repro_torch.train``, ``repro_torch.data``,
``repro_torch.launch.train``) against the reference on the CPU.

* optimizer pieces on random parameter trees: ``lr_schedule`` within rtol
  1e-6, ``adamw_update`` and ``adafactor_update`` parameters and states
  within rtol 1e-5 / atol 1e-7 (the same f32 formulas; the global norm sums
  in another order);
* ``make_train_step`` for 3 AdamW steps from the reference's own initial
  state, on the same ``SyntheticTokens`` batches (the port's numpy copy
  gives equal batches): losses and grad norms within rtol 1e-4, parameters
  within atol 3·lr (AdamW's first move is close to lr·sign(g), so an entry
  whose gradient is near 0 may move the other way);
* the port's own ``train()`` descends on the CPU and gives the same losses
  in two fresh runs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from repro.configs import get_config as ref_get_config
from repro.data import SyntheticTokens as RefSyntheticTokens
from repro.models import Model as RefModel
from repro.models import reduced as ref_reduced
from repro.train import adamw_init as ref_adamw_init
from repro.train import make_train_step as ref_make_train_step
from repro.train import optimizer as ref_opt

from repro_torch.configs import get_config
from repro_torch.data import SyntheticTokens, make_pipeline
from repro_torch.launch.train import build_state, main, to_device, train
from repro_torch.models import Model, reduced
from repro_torch.models.convert import (flatten_reference,
                                        load_reference_params)
from repro_torch.train import make_train_step
from repro_torch.train import optimizer as opt

ARCH = "falcon-mamba-7b"


def _random_tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(0, 1, s).astype(np.float32)
    return {"a": {"w": f(6, 5), "b": f(5)}, "c": f(3, 4, 2), "d": f(7)}


def _as_torch(tree: dict) -> dict:
    return {k: torch.from_numpy(np.array(v))
            for k, v in flatten_reference(tree).items()}


def _close(got: dict, want_tree, **tol):
    want = flatten_reference(jax.tree.map(np.asarray, want_tree))
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **tol)


def test_lr_schedule_matches_reference():
    cfg = opt.OptConfig(learning_rate=1e-3, warmup_steps=10, decay_steps=50)
    ref_cfg = ref_opt.OptConfig(learning_rate=1e-3, warmup_steps=10,
                                decay_steps=50)
    for step in (0, 1, 5, 10, 11, 30, 49, 50, 80):
        want = float(ref_opt.lr_schedule(ref_cfg, jnp.int32(step)))
        assert float(opt.lr_schedule(cfg, step)) == pytest.approx(
            want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizer_updates_match_reference(name):
    cfg = opt.OptConfig(learning_rate=1e-2, warmup_steps=2, decay_steps=20,
                        grad_clip=0.5)
    ref_cfg = ref_opt.OptConfig(learning_rate=1e-2, warmup_steps=2,
                                decay_steps=20, grad_clip=0.5)
    init, update = ((opt.adamw_init, opt.adamw_update) if name == "adamw"
                    else (opt.adafactor_init, opt.adafactor_update))
    ref_init, ref_update = ((ref_opt.adamw_init, ref_opt.adamw_update)
                            if name == "adamw" else
                            (ref_opt.adafactor_init, ref_opt.adafactor_update))
    params = _random_tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _as_torch(params)
    js, ts = ref_init(jp), init(tp)
    for step in range(3):
        grads = _random_tree(10 + step)
        jp, js, jm = ref_update(ref_cfg, jp, jax.tree.map(jnp.asarray, grads),
                                js, jnp.int32(step))
        tp, ts, tm = update(cfg, tp, _as_torch(grads), ts, step)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-5)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        _close(tp, jp, rtol=1e-5, atol=1e-7)
    if name == "adamw":
        _close(ts["m"], js["m"], rtol=1e-5, atol=1e-7)
        _close(ts["v"], js["v"], rtol=1e-5, atol=1e-9)
    else:
        for k in ("vr", "vc"):
            np.testing.assert_allclose(ts["f"]["c"][k].numpy(),
                                       np.asarray(js["f"]["c"][k]), rtol=1e-5)
        np.testing.assert_allclose(ts["f"]["d"]["v"].numpy(),
                                   np.asarray(js["f"]["d"]["v"]), rtol=1e-5)


def test_synthetic_tokens_equal_reference_batches():
    for step in (0, 3):
        got = SyntheticTokens(256, 2, 16, seed=7).batch_at(step)
        want = RefSyntheticTokens(256, 2, 16, seed=7).batch_at(step)
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    cfg = reduced(get_config(ARCH))
    assert isinstance(make_pipeline(cfg, 2, 16), SyntheticTokens)


@pytest.mark.parametrize("ssm_kernel,accum", [(True, 1), (False, 2)])
def test_train_steps_match_reference(ssm_kernel, accum):
    lr = 1e-3
    kw = dict(ssm_chunk=8, dtype="float32", ssm_kernel=ssm_kernel)
    ref_cfg = ref_reduced(ref_get_config(ARCH), **kw)
    cfg = reduced(get_config(ARCH), **kw)
    ref_model = RefModel(ref_cfg)
    params = ref_model.init_params(jax.random.PRNGKey(1))
    ref_state = {"params": params, "opt": ref_adamw_init(params),
                 "step": jnp.zeros((), jnp.int32)}
    model = Model(cfg, device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    state = build_state(model, "adamw")
    ocfg = opt.OptConfig(learning_rate=lr, warmup_steps=1, decay_steps=10)
    ref_ocfg = ref_opt.OptConfig(learning_rate=lr, warmup_steps=1,
                                 decay_steps=10)
    ref_step = jax.jit(ref_make_train_step(ref_model, ref_ocfg,
                                           accum_steps=accum))
    step = make_train_step(model, ocfg, accum_steps=accum)
    source = SyntheticTokens(cfg.vocab_size, 2, 32, seed=5)
    for i in range(3):
        batch = source.batch_at(i)
        ref_state, jm = ref_step(ref_state, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        state, tm = step(state, to_device(batch, torch.device("cpu")))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4), i
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4), i
    assert state["step"] == int(ref_state["step"]) == 3
    want = flatten_reference(jax.tree.map(np.asarray, ref_state["params"]))
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name], rtol=0,
                                   atol=3 * lr, err_msg=name)


def test_port_train_descends_and_is_deterministic(capsys):
    cfg = reduced(get_config(ARCH), n_layers=1)
    runs = [train(cfg, steps=6, batch=2, seq_len=32, lr=5e-3, log_every=100,
                  device="cpu")[1] for _ in range(2)]
    assert len(runs[0]) == 6 and np.isfinite(runs[0]).all()
    assert runs[0][-1] < runs[0][0]
    np.testing.assert_array_equal(runs[0], runs[1])
    main(["--arch", ARCH, "--reduced", "--steps", "2", "--batch", "2",
          "--seq-len", "16", "--device", "cpu"])
    assert "[train] done: 2 steps" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["whisper-medium", "llava-next-34b"])
def test_stub_frontend_train_steps_match_reference(arch, capsys):
    """Three AdamW steps of the two families whose batches carry stub
    embeddings (whisper's frames, llava's patches, from the data
    pipeline) against the reference's train step: loss and grad norm
    within rtol 1e-4; then ``python -m repro_torch.launch.train --arch
    <arch> --reduced --device cpu`` trains."""
    lr = 1e-3
    ref_model = RefModel(ref_reduced(ref_get_config(arch), dtype="float32"))
    params = ref_model.init_params(jax.random.PRNGKey(2))
    ref_state = {"params": params, "opt": ref_adamw_init(params),
                 "step": jnp.zeros((), jnp.int32)}
    model = Model(reduced(get_config(arch), dtype="float32"), device="cpu")
    load_reference_params(model, jax.tree.map(np.asarray, params))
    state = build_state(model, "adamw")
    ocfg = opt.OptConfig(learning_rate=lr, warmup_steps=1, decay_steps=10)
    ref_step = jax.jit(ref_make_train_step(ref_model, ref_opt.OptConfig(
        learning_rate=lr, warmup_steps=1, decay_steps=10)))
    step = make_train_step(model, ocfg)
    source = make_pipeline(model.cfg, 2, 40, seed=3)
    extra = "frames" if arch == "whisper-medium" else "patches"
    for i in range(3):
        batch = source.batch_at(i)
        assert extra in batch
        ref_state, jm = ref_step(ref_state, {k: jnp.asarray(v)
                                             for k, v in batch.items()})
        state, tm = step(state, to_device(batch, torch.device("cpu")))
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-4), i
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-4), i
    main(["--arch", arch, "--reduced", "--steps", "2", "--batch", "2",
          "--seq-len", "24", "--device", "cpu"])
    assert "[train] done: 2 steps" in capsys.readouterr().out
