"""The long-context prefill on a ``torch.distributed`` device mesh
(``src/repro_torch``): under ``LONG_CONTEXT_RULES`` a prompt of one row is
whole on the data axes and its sequence is split over them
(``batch_specs``' "seq"), and ``Model.prefill`` keeps it split, as the
reference's partitioned program does. Each data rank runs its block of
``S / dp`` positions (``sharding.spmd.sequence``) and exchanges only what
crosses blocks: the attention's keys and values (MLA's expanded ones, the
cross-attention's projected from each rank's block of the encoder output),
the Mamba conv window's ``kc - 1`` rows, the scan state (``seq_chain``)
and the last position's row.

Every meshed check runs in one spawned world of 4 gloo ranks on "cpu"
meshes (4, 1), (2, 2) ("data", "model") and (2, 2, 1) ("pod", "data",
"model") at ``reduced(cfg, dtype="float32")`` with a 256-token prompt and
random attention biases; rank 0 prints the world's findings as one JSON
line. Logits are held within rtol and atol 1e-5 of one device, greedy
tokens and every top-k expert choice exactly. The same world counts a
prefill of ranks 0 and 3 with the dry-run's counter; each count must equal
that rank's meta count in a counting world
(``launch.mesh.counting_world``).

In the main process rank 0's FLOPs (the dry-run's count) are held beside
the reference's partitioned prefill: a subprocess compiling it on 4 forced
host devices with the dry-run's in-shardings (``repro/launch/dryrun.py``),
read with ``repro.utils.hlo_cost.analyze``. They differ by named products
only (``prefill_reference_extra``), each one the reference runs whole on
every data rank.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tests"))

import repro_torch.core  # noqa: E402,F401
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch import dryrun as D  # noqa: E402
from repro_torch.launch.mesh import counting_world  # noqa: E402
from repro_torch.models import ShapeSpec, reduced  # noqa: E402
from repro_torch.models import ssm as SSM  # noqa: E402
from repro_torch.models.moe import _capacity  # noqa: E402
from repro_torch.sharding import LONG_CONTEXT_RULES, MeshShape  # noqa: E402
from test_torch_mesh_train import run_world  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)
SEQ = 256
# hymba-1.5b at 5 query heads, which divide no model axis of 2: on (2, 2)
# the context-parallel attention splits each data rank's block again over
# "model"
HYMBA5 = dict(n_heads=5, n_kv_heads=5, d_model=80)
MOE_ARCHS = ("olmoe-1b-7b", "deepseek-v2-lite-16b")
MESHES = ((4, 1), (2, 2), (2, 2, 1))
# (case id, arch, mesh, reduced() overrides)
CASES = tuple(
    (f"{tag}-{'x'.join(map(str, mesh))}", arch, mesh, over)
    for tag, arch, over in (("qwen", "qwen2.5-3b", {}),
                            ("hymba", "hymba-1.5b", {}),
                            ("falcon-mamba", "falcon-mamba-7b", {}),
                            ("olmoe", "olmoe-1b-7b", {}),
                            ("deepseek", "deepseek-v2-lite-16b", {}),
                            ("whisper", "whisper-medium", {}))
    for mesh in MESHES) + tuple(
    (f"{tag}-{'x'.join(map(str, mesh))}", arch, mesh, over)
    for tag, arch, over, meshes in (
        ("falcon-mamba-kernel", "falcon-mamba-7b", {"ssm_kernel": True},
         MESHES),
        ("hymba-kernel", "hymba-1.5b", {"ssm_kernel": True}, ((2, 2),)),
        ("hymba5", "hymba-1.5b", HYMBA5, ((2, 2),)),
        ("llava", "llava-next-34b", {}, ((4, 1), (2, 2))),
        ("olmoe-short", "olmoe-1b-7b", {}, ((4, 1),)),
        ("deepseek-short", "deepseek-v2-lite-16b", {}, ((4, 1),)),
        ("qwen-pod", "qwen2.5-3b", {}, ((2, 2, 1),)),
        ("hymba-pod", "hymba-1.5b", {"ssm_chunk": 13}, ((2, 2, 1),)))
    for mesh in meshes)
# the prompts of other lengths than SEQ: 1 x 128 on (4, 1), 32 positions a
# rank against routing groups of 64 (a MoE block of part of a group); 1 x
# 130 on ("pod", "data", "model") (2, 2, 1), which "pod" divides and "pod"
# x "data" does not (the sequence in blocks over "pod" only; hymba's scan in
# chunks of 13, which divide a block of 65)
SHORT, POD_ONLY = 128, 130
SEQS = {"olmoe-short-4x1": SHORT, "deepseek-short-4x1": SHORT,
        "qwen-pod-2x2x1": POD_ONLY, "hymba-pod-2x2x1": POD_ONLY}
# the prefills whose counts ranks 0 and 3 take, on (2, 2)
COUNT_ARCHS = ("hymba-1.5b", "whisper-medium")
COUNT_RANKS = (0, 3)
COUNT_MESH = (2, 2)
PREFILL = ShapeSpec("prefill", SEQ, 1, "prefill")

WORLD = r'''
import json
import numpy as np
import torch
import torch.distributed as dist
import repro_torch.core  # noqa: F401
import repro_torch.models.moe as MOE
import repro_torch.models.ssm as SSM
import repro_torch.sharding.spmd as SP
from repro_torch.configs import get_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import Model, ShapeSpec, reduced
from repro_torch.sharding import LONG_CONTEXT_RULES as RULES
from repro_torch.sharding.rules import distribute_batch, distribute_params
from repro_torch.sharding.spmd import full_value

torch.set_num_threads(1)
PREFILL = ShapeSpec(*PREFILL)
meshes = {m: make_device_mesh(m, device_type="cpu") for m in ((4, 1), (2, 2))}
meshes[(2, 2, 1)] = make_device_mesh((2, 2, 1), ("pod", "data", "model"),
                                     device_type="cpu")
out = {}

# every all-gather of a meshed prefill (its group's ranks, its input's
# shape), and the experts each top-k picks, one device's and the mesh's
seen = {"on": False, "mode": None, "gathers": [], "one": [], "mesh": [],
        "kept_one": [], "kept_mesh": []}
real_gather, real_top_k = dist.all_gather_into_tensor, MOE._top_k
real_in_capacity = MOE._in_capacity


def gather_spy(out_t, t, group=None, **kw):
    if seen["on"]:
        seen["gathers"].append([dist.get_process_group_ranks(group),
                                list(t.shape)])
    return real_gather(out_t, t, group=group, **kw)


def tokens_of(t):
    """a [..., k] tensor as one list of k entries a token"""
    return t.reshape(-1, t.shape[-1]).tolist()


def top_k_spy(probs, k):
    vals, idx = real_top_k(probs, k)
    if seen["mode"]:
        seen[seen["mode"]].append(tokens_of(idx))
    return vals, idx


def in_capacity_spy(pos, cap):
    kept = real_in_capacity(pos, cap)
    if seen["mode"]:
        seen["kept_" + seen["mode"]].append(tokens_of(kept.amax(dim=-1)))
    return kept


dist.all_gather_into_tensor = gather_spy
MOE._top_k = top_k_spy
MOE._in_capacity = in_capacity_spy


def model_of(cfg):
    """the model at seed 0 with seeded random attention biases"""
    model = Model(cfg, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if name.rsplit(".", 1)[-1] in ("bq", "bk", "bv"):
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    return model


def inputs_of(cfg, seq):
    rng = np.random.default_rng(2)
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                    (1, seq)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.as_tensor(rng.normal(0, 1, (
            1, cfg.n_audio_frames, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["patches"] = torch.as_tensor(rng.normal(0, 1, (
            1, cfg.n_image_tokens, cfg.d_model)).astype(np.float32))
    return batch


def data_index(mesh):
    """this rank's place among the data axes' blocks, and its model rank"""
    idx, model = 0, 0
    for n, c in zip(mesh.mesh_dim_names, mesh.get_coordinate()):
        if n == "model":
            model = c
        else:
            idx = idx * mesh.size(mesh.mesh_dim_names.index(n)) + c
    return idx, model


def kind(shape, blocks, cfg):
    """what an all-gather over a data group carries, by its input's shape
    (the gathered dim moved first)"""
    if len(shape) == 5 and shape[3] == 3 and shape[4] == cfg.n_experts:
        return "routing counts"
    if len(shape) == 4 and shape[0] == 1:
        if shape[2] == 1 and shape[3] == cfg.d_model:
            return "last row"
        if shape[2] == cfg.ssm_conv - 1:
            return "conv window"
        if shape[3] == cfg.ssm_state:
            return "scan state"
    if len(shape) == 4 and shape[0] in blocks and shape[1] == 1:
        return "keys and values"
    if len(shape) >= 2 and shape[0] in blocks and shape[1] == 1:
        return "sequence"         # tokens or activations whole: a fault
    return "weight"               # a parameter's FSDP gather, as before


def every_rank(obj):
    got = [None] * world
    dist.all_gather_object(got, obj)
    return got


def joined(mesh, calls):
    """every data rank's token lists of each call, joined in data order"""
    idx, mrank = data_index(mesh)
    ranks = [c for _, m, c in sorted(every_rank([idx, mrank, calls]),
                                     key=lambda e: e[0]) if m == 0]
    return [sum((c[i] for c in ranks), []) for i in range(len(ranks[0]))]


def run_case(arch, sizes, over, seq):
    mesh = meshes[tuple(sizes)]
    cfg = reduced(get_config(arch), dtype="float32", **over)
    one = model_of(cfg)
    model = distribute_params(model_of(cfg), mesh, RULES)
    batch = inputs_of(cfg, seq)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    seen.update(gathers=[], one=[], mesh=[], kept_one=[], kept_mesh=[],
                mode="one")
    l1 = one.prefill(batch["tokens"], extra=extra)
    placed = distribute_batch(batch, mesh, RULES)
    seen.update(on=True, mode="mesh")
    l2 = model.prefill(placed["tokens"], extra={
        k: v for k, v in placed.items() if k != "tokens"}, rules=RULES)
    seen.update(on=False, mode=None)
    ranks_logits = every_rank(l2.to_local())
    l2 = full_value(l2)
    data = [dist.get_process_group_ranks(mesh.get_group(n))
            for n in mesh.mesh_dim_names if n != "model"]
    # a data rank's positions: of each leaf it holds, and of the VLM's
    # whole sequence in blocks as the tokens are
    with SP.spmd(mesh, 1, RULES):
        kept = {k: SP.local_batch(v).shape[1] for k, v in placed.items()}
    blocks = set(kept.values())
    if cfg.family == "vlm":
        blocks.add((cfg.n_image_tokens + seq) // (seq // kept["tokens"]))
    kinds = sorted({kind(s, blocks, cfg) for g, s in seen["gathers"]
                    if g in data})
    # every data rank's expert choices and kept (token, choice) pairs,
    # joined in data order (a data group's model ranks route alike)
    drops = [1 - v for call in seen["kept_one"] for t in call for v in t]
    return {"err": float((l2 - l1).abs().max()),
            "close": bool(torch.allclose(l2, l1, **TOL)),
            "greedy_equal": bool(torch.equal(l2.argmax(-1), l1.argmax(-1))),
            "same_on_every_rank": all(torch.equal(t, l2)
                                      for t in ranks_logits),
            "experts": [joined(mesh, seen["mesh"]) == seen["one"],
                        len(seen["one"])],
            "kept": [joined(mesh, seen["kept_mesh"]) == seen["kept_one"],
                     int(sum(drops))],
            "block": kept["tokens"],
            "data_gathers": kinds}


for case_id, arch, sizes, over in CASES:
    out[case_id] = run_case(arch, sizes, over, SEQS.get(case_id, SEQ))

# the carried state: a Mamba layer on each data rank's block of a (2, 2)
# mesh, its output rows against one device's, the state it started from
mesh = meshes[(2, 2)]
carried = {}
for route in (False, True):
    cfg = reduced(get_config("falcon-mamba-7b"), dtype="float32",
                  ssm_kernel=route)
    p = {k: v.detach() for k, v in
         Model(cfg, seed=0, device="cpu").params()["blocks"][0]["ssm"]
         .items()}
    x = torch.as_tensor(np.random.default_rng(3).normal(
        0, 1, (1, SEQ, cfg.d_model)).astype(np.float32))
    starts = []
    real_scan = SSM._selective_scan

    def scan_spy(cfg_, xc, dt, bm, cm, a, h0):
        starts.append(float(h0.abs().max()))
        return real_scan(cfg_, xc, dt, bm, cm, a, h0)

    with torch.no_grad():
        y1 = SSM.mamba_forward(p, cfg, x)
        SSM._selective_scan = scan_spy
        try:
            with SP.spmd(mesh, 1, RULES), SP.sequence(SEQ, True):
                idx = SP.seq_block()[0]
                y2 = SSM.mamba_forward(p, cfg, x[:, idx:idx + SEQ // 2])
        finally:
            SSM._selective_scan = real_scan
    every = [None] * world
    dist.all_gather_object(every, [data_index(mesh)[0], float(
        (y2 - y1[:, idx:idx + SEQ // 2]).abs().max()), bool(torch.allclose(
            y2, y1[:, idx:idx + SEQ // 2], **TOL)), starts])
    carried["kernel" if route else "chunked"] = sorted(every)
out["carried"] = carried

# each rank's count of a long-context prefill, as the dry-run counts it
counts = {}
for arch in COUNT_ARCHS:
    fn, inputs = D.step_program(reduced(get_config(arch)), PREFILL,
                                mesh=meshes[tuple(COUNT_MESH)], rules=RULES,
                                device="cpu")
    c = D.trace_counts(fn, inputs)
    every = [None] * world
    dist.all_gather_object(every, c)
    counts[arch] = {str(r): every[r] for r in COUNT_RANKS}
out["counts"] = counts
if rank == 0:
    print("RESULT " + json.dumps(out), flush=True)
'''


def _meta_count(arch: str, rank: int) -> dict:
    with counting_world(MeshShape(("data", "model"), COUNT_MESH),
                        rank) as m:
        fn, inputs = D.step_program(reduced(get_config(arch)), PREFILL,
                                    mesh=m, rules=LONG_CONTEXT_RULES)
        return D.trace_counts(fn, inputs)


@pytest.fixture(scope="module")
def world():
    """The world's findings, and each counted prefill's meta counts, taken
    in this process while the world runs."""
    with ThreadPoolExecutor(1) as pool:
        running = pool.submit(run_world, WORLD, CASES=CASES, SEQ=SEQ,
                              SEQS=SEQS, TOL=TOL,
                              COUNT_ARCHS=COUNT_ARCHS,
                              COUNT_RANKS=COUNT_RANKS, COUNT_MESH=COUNT_MESH,
                              PREFILL=("prefill", SEQ, 1, "prefill"))
        meta = {(a, r): _meta_count(a, r) for a in COUNT_ARCHS
                for r in COUNT_RANKS}
        found = running.result()
    found["meta"] = meta
    return found


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_long_context_prefill_matches_one_device(world, case):
    """The logits within 1e-5 of one device, the same on every rank (a
    DTensor whole over the vocabulary), and the greedy token equal."""
    rec = world[case]
    assert rec["close"], rec["err"]
    assert rec["greedy_equal"]
    assert rec["same_on_every_rank"]


@pytest.mark.parametrize("case", [c[0] for c in CASES
                                  if c[1] in MOE_ARCHS])
def test_long_context_prefill_picks_one_devices_experts(world, case):
    """Each data rank routes its own tokens: every top-k choice and every
    kept or dropped (token, choice) pair, the data ranks' joined in data
    order, equals one device's. A block of whole groups routes them where
    it is; a block of part of a group (the short prompts) takes its
    capacity positions from the counts of the blocks before it, and one
    device drops some of those pairs."""
    equal, calls = world[case]["experts"]
    assert equal and calls > 0
    kept_equal, drops = world[case]["kept"]
    assert kept_equal
    if case in SEQS:
        assert drops > 0


def _not_whole_groups(cfg, case: str, sizes: tuple) -> bool:
    """Whether a MoE case's blocks hold part of a routing group."""
    seq = SEQS.get(case, SEQ)
    block = seq // int(np.prod(sizes[:-1]))
    return cfg.is_moe and block % min(cfg.moe_group_size, seq) != 0


@pytest.mark.parametrize("case", [c[0] for c in CASES])
def test_long_context_prefill_gathers_no_whole_sequence(world, case):
    """No all-gather over a data group carries the tokens or an activation
    of the whole sequence: only the keys and values (MLA's expanded ones,
    the cross-attention's), the conv window, the scan state, the last row
    and, where a block holds part of a routing group, the groups' expert
    counts cross the blocks (and the weights' FSDP gathers, as before).
    The VLM's blocks take their patch rows and token ids by an all-to-all,
    no gather."""
    arch, sizes = dict((c[0], (c[1], c[2])) for c in CASES)[case]
    cfg = reduced(get_config(arch))
    want = {"last row", "weight"}
    if cfg.uses_attention:
        want.add("keys and values")
    if cfg.uses_ssm:
        want |= {"conv window", "scan state"}
    if _not_whole_groups(cfg, case, sizes):
        want.add("routing counts")
    assert set(world[case]["data_gathers"]) == want


@pytest.mark.parametrize("case", [c for c in SEQS if c.endswith("2x2x1")])
def test_a_prompt_split_over_pod_only_keeps_its_block(world, case):
    """A prompt that "pod" divides and "pod" x "data" does not stays in
    blocks over "pod" (half the sequence a rank, the two ranks of "data"
    holding the same block), within 1e-5 of one device."""
    rec = world[case]
    assert rec["block"] == SEQS[case] // 2
    assert rec["close"], rec["err"]


@pytest.mark.parametrize("route", ("chunked", "kernel"))
def test_a_data_rank_scans_from_the_state_the_rank_before_ended_in(
        world, route):
    """A Mamba layer on data rank 1's block of a (2, 2) mesh, given rank
    0's conv rows and final state, equals positions S/2..S of the
    one-device layer; rank 0 starts from zeros, rank 1 from a non-zero
    state (both model ranks of each)."""
    for idx, err, close, starts in world["carried"][route]:
        assert close, (idx, err)
        assert (max(starts) > 0) == (idx == 1), (idx, starts)


def test_the_carried_state_is_the_scan_of_the_positions_before():
    """On one device: the scan of a sequence's second half from the first
    half's final state equals the whole scan's second half, on the chunked
    route and on B7's plain version (the kernel route on the CPU)."""
    rng = np.random.default_rng(4)
    b, s, di, n = 1, 64, 32, 8
    xc, dt = (torch.as_tensor(rng.normal(0, 1, (b, s, di)),
                              dtype=torch.float32) for _ in range(2))
    dt = torch.nn.functional.softplus(dt)
    bm, cm = (torch.as_tensor(rng.normal(0, 1, (b, s, n)),
                              dtype=torch.float32) for _ in range(2))
    a = -torch.exp(torch.as_tensor(rng.normal(0, 1, (di, n)),
                                   dtype=torch.float32))
    for kernel in (False, True):
        cfg = reduced(get_config("falcon-mamba-7b"), ssm_kernel=kernel,
                      ssm_chunk=16, ssm_state=n)
        zeros = torch.zeros((b, di, n))
        with torch.no_grad():
            y, h = SSM._selective_scan(cfg, xc, dt, bm, cm, a, zeros)
            y1, h1 = SSM._selective_scan(cfg, xc[:, :32], dt[:, :32],
                                         bm[:, :32], cm[:, :32], a, zeros)
            y2, h2 = SSM._selective_scan(cfg, xc[:, 32:], dt[:, 32:],
                                         bm[:, 32:], cm[:, 32:], a, h1)
        torch.testing.assert_close(torch.cat([y1, y2], 1), y, **TOL)
        torch.testing.assert_close(h2, h, **TOL)
        assert h1.abs().max() > 0


@pytest.mark.parametrize("arch", COUNT_ARCHS)
def test_a_real_rank_counts_what_its_meta_count_says(world, arch):
    for rank in COUNT_RANKS:
        real = world["counts"][arch][str(rank)]
        meta = world["meta"][(arch, rank)]
        assert {k: v for k, v in real.items() if not k.startswith("peak/")
                } == {k: v for k, v in meta.items()
                      if not k.startswith("peak/")}, rank
        assert real["flops"] > 0


REFERENCE = textwrap.dedent("""
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, os.path.join({root!r}, "src"))
    import jax
    from repro.configs import get_config
    from repro.models import Model, ShapeSpec, reduced, token_spec
    from repro.sharding import (LONG_CONTEXT_RULES as rules,
                                logical_axis_rules, param_specs)
    from repro.sharding.rules import batch_specs
    from repro.utils.hlo_cost import analyze
    from repro.utils.jaxcompat import make_auto_mesh

    out = {{}}
    for arch, sizes, seq in {cells!r}:
        mesh = make_auto_mesh(tuple(sizes), ("data", "model"),
                              devices=jax.devices()[:sizes[0] * sizes[1]])
        nm = lambda t: jax.tree.map(
            lambda s: jax.sharding.NamedSharding(mesh, s), t)
        model = Model(reduced(get_config(arch)))
        spec = ShapeSpec("prefill", seq, 1, "prefill")
        with mesh, logical_axis_rules(mesh, rules):
            batch = token_spec(model.cfg, spec)
            params = jax.eval_shape(model.init_params, jax.random.PRNGKey(0))
            low = jax.jit(
                lambda p, b: model.prefill(p, b["tokens"], extra={{
                    k: v for k, v in b.items() if k != "tokens"}}),
                in_shardings=(nm(param_specs(params, mesh, rules)),
                              nm(batch_specs(batch, mesh, rules)))).lower(
                params, batch)
            key = f"{{arch}}|{{sizes[0]}}x{{sizes[1]}}"
            out[key if seq == {seq} else f"{{key}}|{{seq}}"] = analyze(
                low.compile().as_text()).flops
    print("RESULT " + json.dumps(out))
""")

# the table's cells: six families on (4, 1) and (2, 2), and falcon-mamba on
# one device
REF_CELLS = tuple(
    (a, m) for a in ("falcon-mamba-7b", "hymba-1.5b", "qwen2.5-3b",
                     "olmoe-1b-7b", "deepseek-v2-lite-16b", "whisper-medium")
    for m in ((4, 1), (2, 2))) + (("falcon-mamba-7b", (1, 1)),)
# and the MoE archs' short prompts on (4, 1), whose blocks hold half a
# routing group
SHORT_REF_CELLS = tuple((a, (4, 1), SHORT) for a in MOE_ARCHS)
# rank 0's FLOPs of the reference's partitioned prefill in the production
# archs' cells (falcon-mamba-7b, hymba-1.5b) and qwen2.5-3b's, digit for
# digit
REF_FLOPS = {"falcon-mamba-7b|4x1": 8_421_376,
             "falcon-mamba-7b|2x2": 7_880_704,
             "hymba-1.5b|4x1": 31_490_048, "hymba-1.5b|2x2": 24_657_920,
             "qwen2.5-3b|4x1": 43_024_384, "qwen2.5-3b|2x2": 26_230_784}


@pytest.fixture(scope="module")
def reference_flops():
    cells = tuple((a, m, SEQ) for a, m in REF_CELLS) + SHORT_REF_CELLS
    res = subprocess.run([sys.executable, "-c", REFERENCE.format(
        root=ROOT, cells=cells, seq=SEQ)], capture_output=True,
        text=True, timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    return json.loads([ln for ln in res.stdout.splitlines()
                       if ln.startswith("RESULT ")][-1][len("RESULT "):])


def _port_count(arch: str, sizes: tuple, seq: int = SEQ) -> dict:
    cfg = reduced(get_config(arch))
    with counting_world(MeshShape(("data", "model"), sizes)) as m:
        return D.count_step(cfg, ShapeSpec("prefill", seq, 1, "prefill"),
                            mesh=m, rules=LONG_CONTEXT_RULES)


def _local(n: int, tp: int) -> int:
    """A dim's part on a model rank (whole where tp does not divide it)."""
    return n // tp if n % tp == 0 else n


def prefill_reference_extra(cfg, dp: int, tp: int, s: int = SEQ) -> dict:
    """{product: FLOPs} that the reference's partitioned long-context
    prefill (batch 1, ``s`` positions, reduced widths) counts on rank 0
    beyond the port's, each a product it runs whole on every data rank
    where the port runs each rank's block of the sequence, (dp - 1) / dp
    of each (its model-axis split kept):

    * the flash attention's score and value products (every layer's; MLA's
      over the expanded heads): its loop over the query blocks, whose
      sequence it gathers, runs every block on each rank, the band of a
      windowed mask included;
    * the Mamba scan's output product (``btin,btn->bti``): its loop over
      the chunks runs every chunk on each rank;
    * in each MoE layer the router, the dispatch and combine masks
      (``gtke,gtkec->gtec``), the dispatch (``gtec,gtd->gecd``) and the
      experts' ``wi`` / ``wg``, over every group on each rank, and, without
      a shared expert, the combine (``gtec,gecd->gtd``); it splits the
      experts' ``wo`` and, with a shared expert, the combine over "data" by
      their output columns, which costs the port's block.

    None is work the port repeats: every other product, the MLA expansion
    and the cross-attention's key and value projections included, runs on
    each rank's block in both."""
    cut = (dp - 1) / dp
    d, out = cfg.d_model, {}
    if cfg.uses_attention:
        h = _local(cfg.n_heads, tp)
        dqk, dv = ((cfg.nope_head_dim + cfg.rope_head_dim, cfg.v_head_dim)
                   if cfg.attention == "mla" else (cfg.d_head, cfg.d_head))
        bq, bkv = cfg.attn_chunk_q, cfg.attn_chunk_kv
        band = ((bq + cfg.window - 2) // bkv + 2 if cfg.window
                else s // bkv)
        out["attention"] = cfg.n_layers * (s // bq) * band * 2 * bq * \
            bkv * h * (dqk + dv) * cut
    if cfg.uses_ssm:
        out["scan"] = cfg.n_layers * 2 * s * _local(cfg.d_inner, tp) * \
            cfg.ssm_state * cut
    if cfg.is_moe:
        n_moe = cfg.n_layers - cfg.first_dense_layers
        e, g = _local(cfg.n_experts, tp), min(cfg.moe_group_size, s)
        c = _capacity(cfg, g)
        out["router"] = n_moe * 2 * s * d * cfg.n_experts * cut
        out["dispatch masks"] = n_moe * 2 * (2 * s * cfg.top_k * e * c) * cut
        out["dispatch"] = n_moe * 2 * s * e * c * d * cut
        out["experts wi/wg"] = n_moe * (2 if cfg.mlp == "swiglu" else 1) * \
            2 * s * e * c * d * cfg.moe_d_ff // g * cut
        if not cfg.n_shared_experts:
            out["combine"] = n_moe * 2 * s * e * c * d * cut
    return {k: v for k, v in out.items() if v}


@pytest.mark.parametrize("cell", REF_CELLS,
                         ids=[f"{a}-{m[0]}x{m[1]}" for a, m in REF_CELLS])
def test_rank_zero_long_prefill_flops_are_the_reference_less_named_products(
        reference_flops, cell):
    """Rank 0's FLOPs equal the reference's partitioned prefill's less the
    named products of ``prefill_reference_extra``, digit for digit; on one
    device they are equal."""
    arch, sizes = cell
    key = f"{arch}|{sizes[0]}x{sizes[1]}"
    cfg = reduced(get_config(arch))
    extra = prefill_reference_extra(cfg, *sizes)
    assert _port_count(arch, sizes)["flops"] == \
        reference_flops[key] - sum(extra.values())
    if key in REF_FLOPS:
        assert reference_flops[key] == REF_FLOPS[key]
    if sizes == (1, 1):
        assert not extra


def short_prefill_reference_extra(cfg, dp: int, tp: int, s: int) -> dict:
    """``prefill_reference_extra`` where a data rank's block of ``s / dp``
    positions holds part of a routing group (each rank routes its own
    tokens, ``models.moe._routed_in_blocks``): the same named products but
    the experts'. There the reference splits ``wi``, ``wg`` and ``wo``
    over "data" by ``d_model`` (1 / dp of one device's), while the port
    runs the experts of the groups its block touches over the whole
    ``d_model`` (touched / all groups of one device's): a negative term,
    work the port does beyond the reference's share."""
    out = prefill_reference_extra(cfg, dp, tp, s)
    del out["experts wi/wg"]
    g = min(cfg.moe_group_size, s)
    touched = 1                 # a block of part of one group
    per_group = 2 * _local(cfg.n_experts, tp) * _capacity(cfg, g) * \
        cfg.d_model * cfg.moe_d_ff
    products = 3 if cfg.mlp == "swiglu" else 2
    out["experts"] = (cfg.n_layers - cfg.first_dense_layers) * products * \
        per_group * (s // g / dp - touched)
    return out


@pytest.mark.parametrize("cell", SHORT_REF_CELLS,
                         ids=[f"{a}-{m[0]}x{m[1]}-{s}"
                              for a, m, s in SHORT_REF_CELLS])
def test_rank_zero_short_moe_prefill_flops_less_named_products(
        reference_flops, cell):
    """A block of half a routing group routes its own tokens: rank 0's
    FLOPs are at most the reference's partitioned prefill's and equal to
    them less the named products of ``short_prefill_reference_extra``,
    digit for digit; the one negative term is the experts'."""
    arch, sizes, seq = cell
    cfg = reduced(get_config(arch))
    extra = short_prefill_reference_extra(cfg, *sizes, seq)
    want = reference_flops[f"{arch}|{sizes[0]}x{sizes[1]}|{seq}"]
    got = _port_count(arch, sizes, seq)["flops"]
    assert got == want - sum(extra.values())
    assert got <= want
    assert [k for k, v in extra.items() if v < 0] == ["experts"]


@pytest.mark.parametrize("arch,bound", (("falcon-mamba-7b", 8_421_376),
                                        ("hymba-1.5b", 31_490_048)))
def test_the_split_prefill_does_a_data_ranks_share(arch, bound):
    """On (4, 1) rank 0 counts at most the reference's FLOPs and within
    0.1 % of a quarter of one device's beyond the last row's unembedding,
    which every rank runs: no position-wise product is repeated."""
    cfg = reduced(get_config(arch))
    one = D.count_step(cfg, PREFILL)["flops"]
    unembed = 2 * cfg.d_model * cfg.vocab_size
    got = _port_count(arch, (4, 1))["flops"]
    assert got <= bound
    assert abs(got - unembed - (one - unembed) / 4) <= 1e-3 * one / 4
