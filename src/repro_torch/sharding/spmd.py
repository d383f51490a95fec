"""Running the port's models on a ``DeviceMesh`` (no twin in ``repro``,
whose GSPMD partitioner does this inside ``jit``).

Under a mesh the parameters, the optimizer state and the batch are
DTensors placed by the sharding rules. The model itself runs on plain
local tensors, once a rank, as the reference's ``shard_map`` regions do:

* each rank takes its rows of the batch (``local_batch``: the batch is
  split over the data axes);
* a block gathers its parameters just before it runs (``whole_params``:
  an all-gather over every mesh dim a leaf is split on, FSDP's gather;
  its gradient comes back as each rank's part of the sum over the data
  axes, which the train step reduce-scatters into the parameter's shards);
* every product whose leaves the rules split over "model" keeps this
  rank's part there (``split_over_model``: gathered over the other mesh
  dims only) and runs as a tensor-parallel product, Megatron's pair: the
  input whole over "model" passes ``sum_grads_over_model`` and the output,
  each rank's part of the sum, ``sum_over_model`` (an all-reduce forward).
  These are the attention's and the cross-attention's heads (where their
  ``wk`` / ``wv`` stay whole over "model", the KV heads not dividing it or
  ``SERVING_RULES`` keeping them whole, the query heads alone: each model
  rank projects the self-attention's K and V whole and the
  cross-attention's for its own heads, as the reference's partitioned
  program does, ``models.layers.split_queries``), MLA's heads
  (``wq`` / ``wq_b``, ``wk_b``, ``wv_b``, ``wo``; its ``wq_a`` and
  ``wkv_a`` stay whole, as their specs say, and their outputs enter the
  region), the dense MLP's and the shared expert's hidden units, the
  routed experts (each rank its ``E / tp`` experts' slice of the dispatch
  and the combine), the Mamba mixer's channels (its ``in_proj`` columns
  exchanged into this rank's channels of x and z, ``halves_over_model``;
  ``x_proj`` and ``out_proj`` row-parallel, ``dt_proj`` column-parallel),
  and the unembedding's vocabulary in the cross-entropy (each rank's
  logits, their log-sum-exp from ``max_over_model`` and ``sum_over_model``);
* what the specs keep whole over "model" runs whole, repeated on each
  model rank: the norms, the router, MLA's ``wq_a`` and ``wkv_a``, the
  self-attention's whole K/V projections, the embeddings, and any
  dimension the axis does not divide (the resolver leaves it whole:
  whisper's vocabulary of 51865, hymba's 25 query heads). Two
  such places still split their work, as the reference does: the
  context-parallel flash attention (each rank's query positions) and the
  selective scan of whole channels (each rank's channels). Each region's
  inputs pass ``sum_grads_over_model`` (the identity forward; its gradient
  summed over "model" backward, as ``shard_map``'s transpose sums a
  replicated input) and its output ``gather_over_model`` (an all-gather
  forward; each rank's slice of the gradient backward).

Serving (``Model.prefill``, ``Model.decode_step``) runs the same way,
under no gradient, with the batch placed by any of the reference's rule
sets (``spmd(mesh, rows, rules)``: under ``LONG_CONTEXT_RULES`` every rank
holds the whole batch's rows). A decode step never gathers a leaf that the rules
split over "model": it computes with the leaf's "model" part
(``model_part``) and gathers, exchanges or sums the small activations
instead; attention over a cache split on its slots combines each rank's
softmax statistics in rank order (``combine_softmax_over_model``), and
the greedy token is the argmax over the ranks' runs of the vocabulary
(``argmax_over_model``). Where the rows are whole on the data axes
(``data_axes``: ``LONG_CONTEXT_RULES``' batch of 1), a decode step gathers
no leaf over them either: each keeps its data shard of ``d_model``
(``decode_part``), as the reference's partitioned program keeps each
weight where ``param_specs`` put it; a product whose contracting dim it
is takes x's columns there (``data_block``) and sums the partial
products over the data axes (``sum_over_data``), one whose output dim it
is gives this rank's columns, gathered (``data_whole``). The attention
over the cache, which the rules keep whole over "data", and the leaves
without a data shard (Mamba's ``x_proj`` / ``dt_proj`` / conv, MLA's
``w*_b``, the norms) run whole on every data rank. A MoE layer whose
decode tokens are gathered over the data axes (``gather_rows``: fewer
than one device's group) runs in ``rows_gathered``, where its rows are
whole on every data axis: its router, routed experts and shared expert
keep their data shards the same way.

A prefill under ``LONG_CONTEXT_RULES`` keeps the sequence split as the
batch specs place it: ``local_batch`` keeps each data rank's block of a
leaf whose sequence is split over every data axis (``seq_blocked``), and
the model runs the blocks under ``sequence``. Its helpers give the
block's place (``seq_block``, ``seq_positions``) and carry what crosses
blocks over the data axes: keys and values gathered whole
(``seq_whole``), a causal window's leading rows (``seq_before``), a scan's
state from rank to rank in data order (``seq_chain``), and the last
position's row onto every rank (``seq_last``).

DTensor holds the layouts (placing, ``to_local`` / ``from_local``, the
optimizer's elementwise formulas), not the model's ops, and the
collectives here are ``torch.distributed``'s own calls on the mesh's
groups, not DTensor's: its sharding propagation differs from one PyTorch
release to the next (the card's 2.11 fails on the view of a reduced
gradient that 2.13 takes), weighing every layout of every product on a
2-D mesh costs seconds of host time a product, and its redistribution
over gloo with CUDA tensors crashed on the card's 2.11 where the plain
collectives run. On one device (no context) every helper is the
identity.
"""
from __future__ import annotations

import contextlib
import threading

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.utils.weak import WeakIdKeyDictionary

from .annotate import DEFAULT_RULES, placements, resolve_spec

_state = threading.local()
# {mesh: {mesh dim: this rank's place there}} (``local_rank``)
_LOCAL_RANKS = WeakIdKeyDictionary()


def place(x, sharding) -> DTensor:
    """``x`` in the layout of ``sharding`` (a ``NamedSharding`` or anything
    with ``mesh`` and ``placements``): a DTensor is redistributed, a tensor
    that every rank holds whole keeps its own shard (no communication),
    cut where it lies (the host, say) so that only the shard reaches the
    mesh's device and only the shard is held there."""
    mesh, layout = sharding.mesh, tuple(sharding.placements)
    if isinstance(x, DTensor):
        return x.redistribute(mesh, layout)
    local = local_shard(x, mesh, layout).to(_mesh_device(mesh))
    if local.untyped_storage().nbytes() > local.numel() * local.element_size():
        # a cut that stayed on x's device is a view of the whole of x: the
        # rank keeps its shard only
        local = local.clone(memory_format=torch.contiguous_format)
    return DTensor.from_local(local.contiguous(), mesh, layout,
                              run_check=False, shape=x.shape,
                              stride=x.contiguous().stride())


def replicas(x: DTensor) -> int:
    """How many ranks of its mesh hold each element of ``x``."""
    split = 1
    for p, n in zip(x.placements, x.device_mesh.shape):
        split *= n if isinstance(p, Shard) else 1
    return x.device_mesh.size() // split


def local_rank(mesh, dim) -> int:
    """``mesh.get_local_rank(dim)``, looked up once a mesh and dim: the
    lookup runs tensor ops on the mesh's table of ranks, host work that a
    step would otherwise repeat for every leaf it gathers."""
    ranks = _LOCAL_RANKS.setdefault(mesh, {})
    if dim not in ranks:
        ranks[dim] = mesh.get_local_rank(dim)
    return ranks[dim]


def local_shard(x: torch.Tensor, mesh, layout) -> torch.Tensor:
    """This rank's shard of the whole tensor ``x`` in ``layout``, cut where
    ``x`` lies: DTensor's chunks, the outer mesh dim's first."""
    for m, p in enumerate(layout):
        if isinstance(p, Shard):
            x = torch.chunk(x, mesh.size(m), dim=p.dim)[local_rank(mesh, m)]
    return x


def _mesh_device(mesh) -> torch.device:
    """This rank's device of ``mesh``: the current card for CUDA, and the
    meta device on a mesh of the "fake" backend's process groups
    (``launch.mesh.counting_world``), whose ranks only count, so that no
    shard is allocated."""
    if dist.get_backend(mesh.get_group(0)) == "fake":
        return torch.device("meta")
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def local_shape(shape, mesh, layout) -> tuple:
    """The shape of a rank's shard of a tensor of ``shape`` in ``layout``
    (every split even, as ``resolve_spec`` keeps only axes that divide)."""
    shape = list(shape)
    for m, p in enumerate(layout):
        if isinstance(p, Shard):
            shape[p.dim] //= mesh.size(m)
    return tuple(shape)


def batch_layout(mesh, rows: int, rules=DEFAULT_RULES) -> list:
    """The placements of a batch of ``rows`` rows on ``mesh`` under
    ``rules``: the rows split over the data axes where they divide them,
    whole elsewhere (whole everywhere under ``LONG_CONTEXT_RULES``, whose
    "batch" maps to no axis)."""
    return placements(resolve_spec(("batch",), mesh, dict(rules),
                                   dims=(rows,)), mesh)


def spmd(mesh, rows: int, rules=DEFAULT_RULES):
    """Run the model once a rank on ``mesh`` for a batch of ``rows`` rows
    placed by ``rules`` (the rule set that placed the batch and the caches;
    the helpers below read this context)."""
    return within((mesh, batch_layout(mesh, rows, rules)))


@contextlib.contextmanager
def within(ctx):
    """The context ``ctx`` (a ``current()`` value, None for none) again: a
    recomputation in backward runs in the context of its forward."""
    prev = getattr(_state, "ctx", None)
    _state.ctx = ctx
    try:
        yield
    finally:
        _state.ctx = prev


def current():
    """(mesh, batch placements) of the enclosing ``spmd``, or None."""
    return getattr(_state, "ctx", None)


def local_batch(x):
    """This rank's rows of a batch leaf (a DTensor placed by the batch
    specs); a plain tensor as it is. A leaf whose sequence is split over
    every data axis where the rows are whole (``LONG_CONTEXT_RULES``'
    tokens, patches and frames where the sequence divides the axes:
    ``seq_blocked``) keeps this rank's block of it; a leaf split along
    another dim, or over some of those axes only, is gathered whole
    there."""
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, layout = ctx
    keep = seq_blocked(x)
    t = x.to_local()
    for m in reversed(range(mesh.ndim)):
        p, want = x.placements[m], layout[m]
        if p == want or (keep and p == Shard(1)):
            continue
        if isinstance(want, Shard) or not isinstance(p, Shard):
            raise ValueError(f"a batch leaf placed {x.placements}, not "
                             f"{layout}: place it with distribute_batch")
        t = _gather_along(t, p.dim, mesh.get_group(m), mesh.size(m))
    return t


def whole_batch(x):
    """``local_batch(x)`` with its sequence whole: a block that
    ``local_batch`` keeps is gathered over the data axes (a training step,
    and the cross-attention cache of an encoder output)."""
    t = local_batch(x)
    return gather_over_data(t, 1) if seq_blocked(x) else t


def _partial_over_rows(layout) -> list:
    return [Partial() if isinstance(p, Shard) else Replicate()
            for p in layout]


def _gather_along(t, dim: int, group, n: int) -> torch.Tensor:
    """Every rank of ``group``'s ``t`` concatenated along ``dim`` (``t``
    itself in a group of one)."""
    if n == 1:
        return t
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim)


def _reduce_scatter_along(t, dim: int, group, n: int) -> torch.Tensor:
    """The sum of ``t`` over ``group``, this rank's chunk along ``dim``
    (``t`` itself in a group of one)."""
    if n == 1:
        return t
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((t.shape[0] // n, *t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, group=group)
    return out.movedim(0, dim)


def full_value(x) -> torch.Tensor:
    """The whole value of a DTensor as a plain tensor, on every rank
    (``full_tensor`` by the mesh groups' own collectives; no gradient):
    its ``Partial`` parts summed, its shards gathered. A plain tensor as it
    is."""
    if not isinstance(x, DTensor):
        return x.detach()
    mesh, t = x.device_mesh, x.to_local().detach()
    for m, p in enumerate(x.placements):
        if isinstance(p, Partial):
            t = t.clone().contiguous()
            dist.all_reduce(t, group=mesh.get_group(m))
    for m in reversed(range(mesh.ndim)):
        p = x.placements[m]
        if isinstance(p, Shard):
            t = _gather_along(t, p.dim, mesh.get_group(m), mesh.size(m))
    return t


class _WholeParam(torch.autograd.Function):
    """A parameter's local shard gathered whole (innermost mesh dim first,
    as DTensor nests the chunks) forward; backward, the whole gradient of
    this rank (its part of the sum over the mesh dims the batch is split
    on) summed there and cut to this rank's shard: a reduce-scatter where
    the parameter is split on such a dim, an all-reduce where it is whole
    there, its own chunk where it is split on another. The mesh dim
    ``keep`` (or None) is left as it is both ways: a tensor-parallel
    product uses this rank's part there and gives that part's gradient."""

    @staticmethod
    def forward(ctx, local, mesh, layout, rows, keep=None):
        ctx.mesh, ctx.layout, ctx.rows, ctx.keep = mesh, layout, rows, keep
        t = local
        for m in reversed(range(mesh.ndim)):
            if isinstance(layout[m], Shard) and m != keep:
                t = _gather_along(t, layout[m].dim, mesh.get_group(m),
                                  mesh.size(m))
        # in the parameter's own layout: a product with a transposed view
        # would take another GEMM path and other bits
        return t.contiguous() if t is not local else local.view_as(local)

    @staticmethod
    def backward(ctx, g):
        mesh = ctx.mesh
        for m in range(mesh.ndim):
            if m == ctx.keep or mesh.size(m) == 1:
                continue
            p, split = ctx.layout[m], isinstance(ctx.rows[m], Shard)
            group, n = mesh.get_group(m), mesh.size(m)
            if split and isinstance(p, Shard):
                g = _reduce_scatter_along(g, p.dim, group, n)
            elif split:
                g = g.contiguous().clone()
                dist.all_reduce(g, group=group)
            elif isinstance(p, Shard):
                size = g.shape[p.dim] // n
                g = g.narrow(p.dim, local_rank(mesh, m) * size, size)
        return g.contiguous(), None, None, None, None


def whole_params(tree):
    """Every DTensor leaf of ``tree`` gathered whole, as a plain tensor
    whose gradient reaches the leaf in the leaf's own layout, summed over
    the ranks that hold other rows of the batch; other leaves as they
    are."""
    if isinstance(tree, dict):
        return {k: whole_params(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [whole_params(v) for v in tree]
    ctx = current()
    if ctx is None or not isinstance(tree, DTensor):
        return tree
    mesh, layout = ctx
    return _WholeParam.apply(tree.to_local(), mesh, tuple(tree.placements),
                             tuple(layout))


def split_over_model(tree: dict, dims: dict, whole: tuple = (),
                     optional: tuple = ()):
    """A sublayer's parameters for a tensor-parallel product over "model"
    (Megatron's column- then row-parallel pair), in one of three forms:

    * ``(tree, True)``, every leaf split: each leaf that ``dims`` names
      gathered over every mesh dim but "model" and this rank's part kept
      there, and each leaf that ``whole`` names gathered whole (its spec
      keeps it whole over "model": MLA's ``wq_a`` and ``wkv_a``), when
      every other leaf of ``tree`` is a DTensor split over "model" on its
      ``dims`` tensor dim and on no other mesh dim (so a rank's part is one
      contiguous block: a head axis, an expert axis, a run of channels or
      of the vocabulary);
    * ``(tree, kept)``, split in part: as above, but the leaves that
      ``optional`` names and the rules keep whole over "model" are
      gathered whole too; ``kept`` is the tuple of their names (the
      attention's K/V projections and biases where the KV heads do not
      divide the axis or ``SERVING_RULES`` keeps them whole, its query
      heads split: ``models.layers.attention``);
    * ``(whole_params(tree), False)`` otherwise, and always without a model
      axis of two or more."""
    kept = tuple(k for k in optional if k in tree and
                 model_dim(tree[k]) is None)
    parts = {k: x for k, x in tree.items() if k not in whole + kept}
    if model_axis() is None or not set(parts) <= set(dims) or any(
            _own_model_dim(x) != dims[k] for k, x in parts.items()):
        return whole_params(tree), False
    return ({k: _keep_model_part(x) if k in parts else whole_params(x)
             for k, x in tree.items()}, kept or True)


def batch_sum(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks that hold other rows of the batch
    (no gradient: counts); ``t`` itself without a context."""
    ctx = current()
    if ctx is None:
        return t
    mesh, layout = ctx
    t = t.detach().clone()
    for m, p in enumerate(layout):
        if isinstance(p, Shard):
            dist.all_reduce(t, group=mesh.get_group(m))
    return t


def batch_shards() -> int:
    """How many ways the batch is split (1 without a context)."""
    ctx = current()
    if ctx is None:
        return 1
    mesh, layout = ctx
    n = 1
    for p, size in zip(layout, mesh.shape):
        n *= size if isinstance(p, Shard) else 1
    return n


def as_batch_partial(t: torch.Tensor) -> DTensor:
    """A rank's part ``t`` of a sum over the batch's row shards, as the
    DTensor of that sum (``full_tensor`` gives it; the gradient of its
    local part is the local part's own)."""
    mesh, layout = current()
    return DTensor.from_local(t, mesh, _partial_over_rows(layout),
                              run_check=False)


def as_batch_rows(t: torch.Tensor) -> DTensor:
    """This rank's rows ``t`` of a batch-shaped result, as the DTensor of
    the whole batch."""
    mesh, layout = current()
    return DTensor.from_local(t, mesh, layout, run_check=False)


def model_axis():
    """(process group, this rank's place, size) of the mesh's "model" axis
    inside ``spmd``, or None (no context, no such axis, or size 1)."""
    ctx = current()
    if ctx is None or "model" not in ctx[0].mesh_dim_names:
        return None
    mesh = ctx[0]
    size = mesh.size(mesh.mesh_dim_names.index("model"))
    if size == 1:
        return None
    return mesh.get_group("model"), local_rank(mesh, "model"), size


class _SumGrads(torch.autograd.Function):
    """Identity forward; the gradient summed over ``group`` backward."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Gather(torch.autograd.Function):
    """Every rank's ``x`` concatenated along ``dim`` (rank order) forward;
    this rank's slice of the gradient backward."""

    @staticmethod
    def forward(ctx, x, group, dim, rank, size):
        ctx.dim, ctx.rank, ctx.size = dim, rank, size
        return _gather_along(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.size
        return (g.narrow(ctx.dim, ctx.rank * n, n).contiguous(), None, None,
                None, None)


class _SumOver(torch.autograd.Function):
    """The sum over ``group`` forward (an all-reduce); the gradient as it
    is backward (every rank's output is the same sum)."""

    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def sum_over_model(x: torch.Tensor) -> torch.Tensor:
    """The exit of a tensor-parallel product: each model rank's part of
    ``x`` summed over the axis."""
    axis = model_axis()
    return x if axis is None else _SumOver.apply(x, axis[0])


def sum_grads_over_model(x: torch.Tensor) -> torch.Tensor:
    """The entry of a region split over "model": ``x`` as it is, its
    gradient (each rank's part) summed over the axis."""
    axis = model_axis()
    return x if axis is None else _SumGrads.apply(x, axis[0])


def max_over_model(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over "model" (``x`` itself without a
    model axis), with no gradient: the shift of a log-sum-exp, whose
    gradient does not depend on it. Taken from every rank's ``x`` gathered
    in rank order, so every rank holds the same bits."""
    x = x.detach()
    return x if model_axis() is None else _stack_over_model(x).amax(dim=0)


def _halves_chunks(rank: int, tp: int, inverse: bool):
    """The bookkeeping of ``halves_over_model``: a dim of two halves in
    ``2 tp`` equal chunks, chunk ``j`` of the leaf's layout held by rank
    ``j // 2`` and wanted by rank ``j % tp`` (chunk ``s`` is rank ``s``'s
    part of the first half, chunk ``tp + s`` of the second). Returns (the
    chunks this rank holds, those it wants, each chunk's sender, each
    chunk's receiver), forward or ``inverse``."""
    layout, chans = [2 * rank, 2 * rank + 1], [rank, tp + rank]
    owner, user = (lambda j: j // 2), (lambda j: j % tp)
    if inverse:
        return chans, layout, user, owner
    return layout, chans, owner, user


def _exchange_halves(t, dim: int, group, rank: int, tp: int,
                     inverse: bool) -> torch.Tensor:
    """One all-to-all over "model" of ``t``'s chunks along ``dim``
    (``_halves_chunks``), in the rank order of the group on every rank."""
    have, want, sender, receiver = _halves_chunks(rank, tp, inverse)
    u = t.shape[dim] // len(have)
    t = t.movedim(dim, 0)
    pieces = dict(zip(have, t.split(u)))
    send = sorted(have, key=lambda j: (receiver(j), j))
    recv = sorted(want, key=lambda j: (sender(j), j))
    inp = torch.cat([pieces[j] for j in send]).contiguous()
    out = inp.new_empty((len(want) * u, *inp.shape[1:]))
    dist.all_to_all_single(
        out, inp, [sum(sender(j) == q for j in want) * u for q in range(tp)],
        [sum(receiver(j) == q for j in have) * u for q in range(tp)],
        group=group)
    got = dict(zip(recv, out.split(u)))
    return torch.cat([got[j] for j in want]).movedim(0, dim)


class _Halves(torch.autograd.Function):
    """``_exchange_halves`` forward; the reverse exchange of the gradient
    backward."""

    @staticmethod
    def forward(ctx, x, dim, group, rank, size):
        ctx.args = (dim, group, rank, size)
        return _exchange_halves(x, dim, group, rank, size, False)

    @staticmethod
    def backward(ctx, g):
        return (_exchange_halves(g, *ctx.args, True).contiguous(), None,
                None, None, None)


def halves_over_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """A tensor split over "model" along ``dim`` in the rules' layout of a
    dim made of two halves (Mamba's ``in_proj`` columns ``[x | z]``, or
    their product): this rank's contiguous block in, this rank's run of
    channels of each half side by side out, ``[x_r | z_r]``. On a model
    axis of 2, rank 0's block is all of x and rank 1's all of z; an
    all-to-all over "model" sends each run to its rank (a quarter of the
    block each way there), and the gradient goes back by the reverse
    exchange. ``x`` itself without a model axis."""
    axis = model_axis()
    if axis is None:
        return x
    group, rank, size = axis
    return _Halves.apply(x, dim % x.dim(), group, rank, size)


def gather_over_model(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The exit of a region split over "model": every model rank's ``x``
    concatenated along ``dim``."""
    axis = model_axis()
    if axis is None:
        return x
    group, rank, size = axis
    return _Gather.apply(x, group, dim % x.dim(), rank, size)


# ---------------------------------------------------------------------------
# serving: the decode step once a rank (no gradient)
# ---------------------------------------------------------------------------

def model_dim(x) -> int | None:
    """The tensor dim of the DTensor ``x`` split over "model" inside
    ``spmd``, or None (whole there, a plain tensor, no context, or a model
    axis of one)."""
    if model_axis() is None or not isinstance(x, DTensor):
        return None
    m = x.device_mesh.mesh_dim_names.index("model")
    p = x.placements[m]
    return p.dim if isinstance(p, Shard) else None


def _own_model_dim(x) -> int | None:
    """``model_dim(x)`` where no other mesh dim splits that tensor dim (so
    a rank's part there is one contiguous block), else None."""
    dim = model_dim(x)
    names = x.device_mesh.mesh_dim_names if dim is not None else ()
    if any(isinstance(p, Shard) and p.dim == dim and names[i] != "model"
           for i, p in enumerate(x.placements if names else ())):
        return None
    return dim


def _keep_model_part(x) -> torch.Tensor:
    """The DTensor ``x`` gathered over every mesh dim but "model"."""
    mesh, layout = current()
    return _WholeParam.apply(x.to_local(), mesh, tuple(x.placements),
                             tuple(layout),
                             mesh.mesh_dim_names.index("model"))


def model_part(x):
    """``(t, dim)``: a parameter gathered over every mesh dim but "model",
    with this rank's part kept there along tensor dim ``dim``, where the
    leaf is split over "model" on a dim no other mesh dim splits; else
    ``(whole_params(x), None)``. A decode step computes with the part and
    never gathers such a leaf over "model" (``decode_part``, which keeps
    its data shard as well where the rows are whole on the data axes)."""
    dim = _own_model_dim(x)
    return (whole_params(x), None) if dim is None else (_keep_model_part(x),
                                                         dim)


def model_parts(tree: dict) -> tuple[dict, dict]:
    """``model_part`` of every leaf of a sublayer's parameters for a decode
    step, each leaf's data shard kept where the rows are whole on the data
    axes (``decode_part``): ({name: tensor}, {name: "model" dim or
    None})."""
    parts = {k: decode_part(v) for k, v in tree.items()}
    return ({k: t for k, (t, _) in parts.items()},
            {k: d for k, (_, d) in parts.items()})


# ---------------------------------------------------------------------------
# serving: a decode step whose rows are whole on the data axes
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def rows_gathered(on: bool = True):
    """Inside (``on``), the batch's rows count as whole on every data axis,
    as they are once ``gather_rows`` has gathered them: a decode step's MoE
    layer, whose tokens are fewer than one device's group
    (``models.moe.gathers_rows``). ``data_axes`` then names every mesh dim
    but "model" of two or more ranks, so ``decode_part`` / ``decode_split``
    keep each leaf's data shard of ``d_model`` and ``data_block``,
    ``sum_over_data`` and ``data_whole`` work over those dims, as the
    reference's partitioned program keeps the expert weights' ``fsdp``
    shards. ``on`` False: as outside."""
    prev = getattr(_state, "gathered", False)
    _state.gathered = on
    try:
        yield
    finally:
        _state.gathered = prev


def data_axes() -> tuple:
    """The mesh dims, "model" aside, of two or more ranks on which the
    batch's rows are whole inside ``spmd`` (every data axis under
    ``LONG_CONTEXT_RULES``, whose "batch" maps to none, and inside
    ``rows_gathered``); () where the rows are split on every such dim, and
    without a context."""
    ctx = current()
    if ctx is None:
        return ()
    mesh, layout = ctx
    gathered = getattr(_state, "gathered", False)
    return tuple(m for m in range(mesh.ndim)
                 if mesh.mesh_dim_names[m] != "model" and mesh.size(m) > 1
                 and (gathered or not isinstance(layout[m], Shard)))


def _data_dim(x) -> int | None:
    """The tensor dim of the DTensor ``x`` that every data axis splits (its
    ``fsdp`` dim, ``d_model``) and no other mesh dim does, so that a rank's
    shard there is one contiguous block, DTensor's chunks nested outer
    axis first; None otherwise, and for a plain tensor."""
    axes = data_axes()
    if not axes or not isinstance(x, DTensor):
        return None
    ps, sizes = x.placements, x.device_mesh.shape
    d = ps[axes[0]].dim if isinstance(ps[axes[0]], Shard) else None
    if d is None or any(ps[m] != Shard(d) for m in axes) or any(
            ps[m] == Shard(d) and sizes[m] > 1 and m not in axes
            for m in range(len(ps))):
        return None
    return d


def decode_part(x, keep_model: bool = True):
    """``model_part(x)`` for a decode step: ``(t, dim)``, ``dim`` the tensor
    dim of this rank's part over "model" (None: whole there). Where the
    rows are whole on the data axes and the leaf is split over them
    (``_data_dim``), the rank keeps its data shard as well (a block of
    ``d_model``, which the products recognise by its width) and the leaf is
    gathered only over the mesh dims where the rows are split, as the
    reference's partitioned program keeps each weight where
    ``param_specs`` put it; otherwise ``model_part``. ``keep_model`` False:
    gathered over "model" too (a product that the rules do not split
    there)."""
    if _data_dim(x) is None:
        return model_part(x) if keep_model else (whole_params(x), None)
    mesh = x.device_mesh
    mdim = _own_model_dim(x) if keep_model else None
    keep = set(data_axes())
    if mdim is not None:
        keep.add(mesh.mesh_dim_names.index("model"))
    t = x.to_local()
    for m in reversed(range(mesh.ndim)):
        p = x.placements[m]
        if isinstance(p, Shard) and m not in keep:
            t = _gather_along(t, p.dim, mesh.get_group(m), mesh.size(m))
    return t, mdim


def decode_split(tree: dict, dims: dict):
    """``split_over_model(tree, dims)`` for a decode step: ``(tree,
    split)``, each leaf's data shard kept as ``decode_part`` keeps it."""
    if not data_axes():
        return split_over_model(tree, dims)
    split = model_axis() is not None and set(tree) <= set(dims) and all(
        _own_model_dim(x) == dims[k] for k, x in tree.items())
    return {k: decode_part(x, split)[0] for k, x in tree.items()}, split


def _data_index() -> int:
    """This rank's place among the data axes' blocks (outer axis first)."""
    mesh, _ = current()
    index = 0
    for m in data_axes():
        index = index * mesh.size(m) + local_rank(mesh, m)
    return index


def data_block(x: torch.Tensor, n: int) -> torch.Tensor:
    """This rank's block of ``n`` of the last dim of ``x``, which is whole
    on the data axes: the columns that meet a leaf's data shard of ``n``
    rows of a contracting dim; ``x`` itself where ``n`` is its width."""
    if x.shape[-1] == n:
        return x
    return x.narrow(-1, _data_index() * n, n)


def sum_over_data(*ts) -> list:
    """Each of ``ts`` (partial products over a contracting dim split over
    the data axes, one dtype) summed over those axes, by one all-reduce an
    axis for all of them; a None stays None."""
    mesh, _ = current()
    parts = [t for t in ts if t is not None]
    flat = torch.cat([t.reshape(-1) for t in parts])
    for m in data_axes():
        dist.all_reduce(flat, group=mesh.get_group(m))
    sums = iter(f.view(t.shape) for f, t in zip(
        flat.split([t.numel() for t in parts]), parts))
    return [None if t is None else next(sums) for t in ts]


def data_whole(y: torch.Tensor, width: int) -> torch.Tensor:
    """``y`` with its last dim whole: where it holds this rank's block of
    ``width`` (the product of a leaf split over the data axes on its output
    dim), every rank's block gathered over those axes, inner axis first."""
    if y.shape[-1] == width:
        return y
    return gather_over_data(y, y.dim() - 1)


def gather_over_data(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every data rank's ``t`` concatenated along ``dim`` in data order
    (``_data_index``: the inner axis gathered first); ``t`` itself without
    data axes."""
    if not data_axes():
        return t
    mesh, _ = current()
    for m in reversed(data_axes()):
        t = _gather_along(t, dim, mesh.get_group(m), mesh.size(m))
    return t


# ---------------------------------------------------------------------------
# serving: a prefill whose sequence is split over the data axes
# ---------------------------------------------------------------------------

def seq_blocked(x) -> bool:
    """Whether the batch leaf ``x`` (a DTensor placed by the batch specs)
    has its sequence (dim 1) split over every data axis (``data_axes``:
    the rows are whole there) and over no other mesh dim of two or more
    ranks: ``LONG_CONTEXT_RULES``' tokens, patches and frames where the
    sequence divides the axes. Each rank then holds one block of ``S / dp``
    consecutive positions, the ``_data_index``-th."""
    axes = data_axes()
    if not axes or not isinstance(x, DTensor):
        return False
    return {m for m, p in enumerate(x.placements)
            if p == Shard(1) and x.device_mesh.size(m) > 1} == set(axes)


def data_ways() -> int:
    """The number of data ranks (the product of ``data_axes``' sizes)."""
    ways = 1
    if data_axes():
        mesh, _ = current()
        for m in data_axes():
            ways *= mesh.size(m)
    return ways


@contextlib.contextmanager
def sequence(total: int, blocked: bool):
    """Run a model's sequence of ``total`` positions in blocks over the
    data axes (``blocked``: each rank holds its ``_data_index``-th block of
    ``total / dp`` positions, as ``local_batch`` keeps a ``seq_blocked``
    leaf) or whole; the helpers below read it."""
    prev = getattr(_state, "seq", None)
    _state.seq = (total, total // data_ways()) if blocked else None
    try:
        yield
    finally:
        _state.seq = prev


def seq_block():
    """(start, length, total) of this rank's block of the sequence inside
    ``sequence(..., blocked=True)``; None where the sequence is whole."""
    seq = getattr(_state, "seq", None)
    if seq is None or current() is None:
        return None
    total, n = seq
    return _data_index() * n, n, total


def seq_positions(b: int, n: int, device) -> torch.Tensor:
    """[b, n] positions of this rank's block (from its start), or of the
    first ``n`` positions where the sequence is whole."""
    blk = seq_block()
    start = 0 if blk is None else blk[0]
    return torch.arange(start, start + n, device=device).expand(b, n)


def seq_key_positions(positions: torch.Tensor) -> torch.Tensor:
    """The positions of the keys a block's queries attend to, [B, S]: the
    whole sequence's where it is in blocks (``seq_whole``'s keys);
    ``positions`` itself where it is whole."""
    blk = seq_block()
    if blk is None:
        return positions
    return torch.arange(blk[2], device=positions.device).expand(
        positions.shape[0], blk[2])


def seq_whole(t: torch.Tensor, dim: int = 1) -> torch.Tensor:
    """A block of the sequence along ``dim`` gathered whole over the data
    axes (the keys and values that a block's queries attend to); ``t``
    itself where the sequence is whole."""
    return t if seq_block() is None else gather_over_data(t, dim)


def _stack_over_data(t: torch.Tensor) -> torch.Tensor:
    """[dp, *t.shape]: every data rank's ``t``, in data order."""
    return gather_over_data(t.contiguous()[None], 0)


def seq_before(t: torch.Tensor, rows: int) -> torch.Tensor:
    """[B, rows, ...]: the ``rows`` positions just before this rank's block
    ``t`` [B, n, ...] of the sequence, taken from the blocks of the data
    ranks before it (each rank's last ``min(rows, n)`` positions gathered
    once), zeros before position 0: a causal convolution's window. Zeros
    where the sequence is whole."""
    b, n = t.shape[:2]
    zeros = t.new_zeros((b, rows, *t.shape[2:]))
    if seq_block() is None or rows == 0:
        return zeros
    k = min(rows, n)
    # zeros, then every rank's tail in data order: the rows before block
    # idx end where rank idx's tail starts (the same ops on every rank)
    tails = _stack_over_data(t[:, n - k:]).movedim(0, 1).flatten(1, 2)
    return torch.cat([zeros, tails], dim=1).narrow(1, _data_index() * k,
                                                   rows)


def seq_chain(fn, h: torch.Tensor):
    """``fn(h_in) -> (out, h_out)`` run by every data rank on its block in
    data order, each rank's ``h_in`` the ``h_out`` of the rank before it
    (``h`` on the first): the carried state of a scan over a sequence split
    over the data axes. Returns (this rank's out, its h_out). The state
    passes by one all-gather over the data axes a step (``dp - 1`` steps,
    the state the same shape on every rank), a collective that gloo runs on
    CUDA tensors where it runs no send or receive. ``fn(h)`` where the
    sequence is whole."""
    if seq_block() is None:
        return fn(h)
    idx, out = _data_index(), None
    for j in range(data_ways()):
        if j == idx:
            out, h = fn(h)
        if j < data_ways() - 1:
            got = _stack_over_data(h)
            if idx == j + 1:
                h = got[j]
    return out, h


def seq_last(t: torch.Tensor) -> torch.Tensor:
    """The last position's row of the sequence on every rank: ``t`` is this
    rank's last row [B, 1, ...], the last data rank's is every rank's
    (gathered over the data axes); ``t`` itself where the sequence is
    whole."""
    return t if seq_block() is None else _stack_over_data(t)[-1]


def model_slice(t: torch.Tensor, dim: int) -> torch.Tensor:
    """This model rank's contiguous part of a tensor whole along ``dim``
    (DTensor's chunk); ``t`` itself without a model axis."""
    axis = model_axis()
    if axis is None:
        return t
    _, rank, size = axis
    n = t.shape[dim] // size
    return t.narrow(dim, rank * n, n)


def _stack_over_model(t: torch.Tensor) -> torch.Tensor:
    """[size, *t.shape]: every model rank's ``t``, in rank order."""
    group, _, size = model_axis()
    out = t.new_empty((size * t.numel(),))
    dist.all_gather_into_tensor(out, t.contiguous().reshape(-1), group=group)
    return out.view(size, *t.shape)


def combine_softmax_over_model(m: torch.Tensor, l: torch.Tensor,
                               acc: torch.Tensor) -> torch.Tensor:
    """Attention over keys split over "model" (a cache's sequence): each
    rank's running max ``m``, sum ``l`` of exp(score - m) and weighted
    values ``acc`` (``[..., dv]``) gathered and combined, rank after rank in
    rank order on every rank, so the result does not depend on the
    collective's own order; returns acc / l over every key."""
    ms, ls, accs = (_stack_over_model(t) for t in (m, l, acc))
    top = ms.amax(dim=0)
    total_l = torch.zeros_like(l)
    total_acc = torch.zeros_like(acc)
    for r in range(ms.shape[0]):
        w = torch.exp(ms[r] - top)
        total_l = total_l + ls[r] * w
        total_acc = total_acc + accs[r] * w[..., None]
    return total_acc / torch.clamp_min(total_l[..., None], 1e-30)


def argmax_over_model(logits: torch.Tensor, split: bool) -> torch.Tensor:
    """``torch.argmax(..., dim=-1)`` of logits whose last dim holds this
    rank's contiguous run of the vocabulary when ``split`` (the whole of
    it otherwise): each rank's best (value, global index) gathered over
    "model" and the best kept in rank order, a tie going to the lowest
    global index, as ``torch.argmax`` breaks it on one device."""
    idx = torch.argmax(logits, dim=-1)
    if not split or model_axis() is None:
        return idx
    _, rank, _ = model_axis()
    val = torch.gather(logits, -1, idx[..., None])[..., 0]
    vals = _stack_over_model(val)
    idxs = _stack_over_model(idx + rank * logits.shape[-1])
    best_v, best_i = vals[0], idxs[0]
    for r in range(1, vals.shape[0]):
        take = vals[r] > best_v
        best_v = torch.where(take, vals[r], best_v)
        best_i = torch.where(take, idxs[r], best_i)
    return best_i


def row_shard_index() -> int:
    """This rank's place among the batch's row shards (0 where the rows
    are whole, and without a context)."""
    ctx = current()
    if ctx is None:
        return 0
    mesh, layout = ctx
    index = 0
    for m, p in enumerate(layout):
        if isinstance(p, Shard):
            index = index * mesh.size(m) + local_rank(mesh, m)
    return index


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every row shard's ``x`` concatenated along dim 0 (the whole batch,
    in DTensor's chunk order); its gradient is this rank's rows. ``x``
    itself where the rows are whole or without a context."""
    ctx = current()
    if ctx is None:
        return x
    mesh, layout = ctx
    for m in reversed(range(mesh.ndim)):
        if isinstance(layout[m], Shard):
            x = _Gather.apply(x, mesh.get_group(m), 0,
                              local_rank(mesh, m), mesh.size(m))
    return x


def take_rows(x: torch.Tensor) -> torch.Tensor:
    """This rank's rows of a whole-batch ``x`` (``gather_rows`` undone)."""
    ctx = current()
    if ctx is None:
        return x
    mesh, layout = ctx
    for m, p in enumerate(layout):
        if isinstance(p, Shard):
            n = x.shape[0] // mesh.size(m)
            x = x.narrow(0, local_rank(mesh, m) * n, n)
    return x


__all__ = ["place", "replicas", "local_rank", "local_shard", "local_shape",
           "batch_layout",
           "spmd", "within", "current", "local_batch",
           "whole_params", "split_over_model", "full_value", "batch_sum",
           "batch_shards", "as_batch_partial", "as_batch_rows",
           "model_axis", "sum_grads_over_model", "sum_over_model",
           "max_over_model", "halves_over_model", "gather_over_model",
           "model_dim", "model_part", "model_parts",
           "rows_gathered", "data_axes", "decode_part", "decode_split",
           "data_block",
           "sum_over_data", "data_whole", "gather_over_data",
           "whole_batch", "seq_blocked", "data_ways", "sequence", "seq_block",
           "seq_positions", "seq_key_positions", "seq_whole", "seq_before",
           "seq_chain", "seq_last",
           "model_slice", "combine_softmax_over_model", "argmax_over_model",
           "row_shard_index", "gather_rows", "take_rows"]
