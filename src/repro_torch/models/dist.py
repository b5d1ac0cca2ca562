"""The model's few DTensor regions: code that runs on each rank's local
shards where DTensor has no sharding rule, or where a hand-written
kernel needs a device pointer.

A sharded step (``launch.sharding``) hands the model DTensors: global
views whose ops DTensor propagates and redistributes, so a sharded step
computes the function the unsharded one does.  A DTensor has no
``data_ptr()``, so ``flash_attention`` and ``moe_plan`` (``ctypes``
launches) run inside :func:`run_local` (``local_map``) on the local
shards, at the placements where the op is local, as GSPMD would keep it:
attention with batch over the data axes and heads over ``model``; the
dispatch plan replicated.  So do the regions DTensor has no rule for,
or splits wrongly: the MoE scatter, expert FFNs, gather and weighting
(``models.moe``), the vocab-parallel embedding and the SSD scan
(``models.mamba2``).  A region's input that a rank holds whole while
the work is split gets a partial gradient (``in_grad_placements``).
On plain tensors every helper calls its function as it is.

The mesh axis that carries tensor parallelism is named ``"model"``
(``launch.mesh``); every other axis carries the batch.
"""
from __future__ import annotations

import contextlib

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.distributed.tensor.placement_types import Placement

MODEL_AXIS = "model"


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)


@contextlib.contextmanager
def scope(x):
    """Inside, when ``x`` is a DTensor, a tensor that meets a DTensor in
    an op is taken as replicated (the positions, masks and constants
    the model makes on the fly), as ``implicit_replication`` does; the
    setting is restored on exit, so scopes nest."""
    if not is_dtensor(x):
        yield
        return
    disp = DTensor._op_dispatcher
    old = disp._allow_implicit_replication
    disp._allow_implicit_replication = True
    try:
        yield
    finally:
        disp._allow_implicit_replication = old


def run_local(fn, out_placements, in_placements, *args,
              in_grad_placements=None):
    """``fn(*local shards)`` with each DTensor argument first
    redistributed to its entry of ``in_placements``; the outputs become
    DTensors of ``out_placements`` on the arguments' mesh (one tuple of
    placements for one output, a tuple of them for several).
    ``in_grad_placements``: the layout of each argument's local gradient
    where it is not the argument's own (``Partial()`` where each rank's
    gradient is a share of the sum)."""
    if isinstance(out_placements[0], Placement):
        out_placements = list(out_placements)         # one output

    def local(*xs):
        return fn(*(_ContiguousGrad.apply(x) if isinstance(x, torch.Tensor)
                    and x.requires_grad else x for x in xs))

    return local_map(local, out_placements=out_placements,
                     in_placements=in_placements,
                     in_grad_placements=in_grad_placements,
                     redistribute_inputs=True)(*args)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient leaves contiguous: DTensor views a
    local gradient as it would view the whole tensor, which a strided
    local gradient (an einsum's, say) does not allow."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def replicated(mesh) -> tuple:
    return (Replicate(),) * mesh.ndim


def model_size(mesh) -> int:
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(MODEL_AXIS)) if MODEL_AXIS in names else 1


def model_rank(mesh) -> int:
    """This rank's coordinate on the model axis (0 without one)."""
    names = mesh.mesh_dim_names or ()
    return mesh.get_local_rank(MODEL_AXIS) if MODEL_AXIS in names else 0


def batch_and(xs, model_dim_placement) -> tuple:
    """The batch placements of the DTensors ``xs`` (``Shard(0)`` on a
    batch axis where any of them is so sharded, else replicated) with
    ``model_dim_placement`` on the model axis."""
    names = xs[0].device_mesh.mesh_dim_names or ()
    out = []
    for i, name in enumerate(names):
        if name == MODEL_AXIS:
            out.append(model_dim_placement)
        elif any(isinstance(x.placements[i], Shard) and
                 x.placements[i].dim == 0 for x in xs if is_dtensor(x)):
            out.append(Shard(0))
        else:
            out.append(Replicate())
    return tuple(out)


def attend(fn, q, k, v):
    """``fn(q, k, v)`` (``[B, S, H, vd]``) with its heads merged: ``[B,
    S, H * vd]``.  For DTensors on local shards: batch as ``q`` or the
    cache ``k`` rides the data axes, heads (dim 2) over ``model`` when
    both head counts divide it (a rank's query heads then read only its
    own kv heads), else whole heads on each rank (``k`` and ``v``
    gathered, as for a sequence-sharded cache).  The merge is local, so
    the gradient comes back in the output's layout."""
    def merged(q, k, v):
        out = fn(q, k, v)
        return out.reshape(*out.shape[:2], -1)

    if not is_dtensor(q):
        return merged(q, k, v)
    m = model_size(q.device_mesh)
    heads = q.shape[2] % m == 0 and k.shape[2] % m == 0
    pl = batch_and((k, q), Shard(2) if heads else Replicate())
    return run_local(lambda a, b, c: merged(a.contiguous(), b.contiguous(),
                                            c.contiguous()),
                     pl, (pl, pl, pl), q, k, v)


def replicate(x):
    """A DTensor replicated on every mesh axis (a tensor as it is)."""
    if not is_dtensor(x):
        return x
    return x.redistribute(x.device_mesh, replicated(x.device_mesh))


def reduced(x):
    """A DTensor with its pending sums (``Partial`` placements) done, its
    shards kept (a tensor as it is)."""
    if not is_dtensor(x) or not any(p.is_partial() for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in x.placements))


def local_shape_offset(shape, mesh, placements) -> tuple:
    """(this rank's shard shape, its offset in the whole tensor) under
    ``placements``, as ``Shard`` splits a dim (``torch.chunk``: chunks
    of ``ceil(n / ranks)``, the last ones shorter or empty), from the
    mesh coordinate alone (no tensor op: it runs under
    ``FakeTensorMode`` too)."""
    coord = mesh.get_coordinate()
    shape, offset = list(shape), [0] * len(shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            full = shape[p.dim]
            chunk = -(-full // mesh.size(i))
            start = min(coord[i] * chunk, full)
            shape[p.dim] = max(0, min(chunk, full - start))
            offset[p.dim] += start
    return tuple(shape), tuple(offset)


def write_seq(dst, src, start: int) -> None:
    """``dst[:, start:start + S] = src`` in place (a cache write, S =
    ``src.shape[1]``).  A DTensor cache sharded on its sequence dim
    (``launch.sharding.cache_specs``' fallback) is written on each rank's
    own rows: ``src`` is gathered on that dim and each rank copies the
    positions its shard holds."""
    s = src.shape[1]
    if not is_dtensor(dst) or not any(
            isinstance(p, Shard) and p.dim == 1 for p in dst.placements):
        dst[:, start:start + s] = src
        return
    mesh = dst.device_mesh
    pl = tuple(Replicate() if isinstance(p, Shard) and p.dim == 1 else p
               for p in dst.placements)
    full = src.redistribute(mesh, pl).to_local() if is_dtensor(src) else src
    shape, offset = local_shape_offset(dst.shape, mesh, dst.placements)
    lo, hi = max(start, offset[1]), min(start + s, offset[1] + shape[1])
    if lo < hi:
        dst.to_local()[:, lo - offset[1]:hi - offset[1]] = \
            full[:, lo - start:hi - start]


def unshard(x, dim: int):
    """A DTensor gathered on tensor dim ``dim`` (its other shards kept):
    the read of a sequence-sharded cache."""
    if not is_dtensor(x) or not any(
            isinstance(p, Shard) and p.dim == dim for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if isinstance(p, Shard) and p.dim == dim else p
        for p in x.placements))


def embed_rows(table, ids):
    """``table[ids]`` (``table [V, d]``).  On DTensors, vocab-parallel
    as Megatron gathers: each rank keeps its vocab rows (the table's
    other dim gathered), looks up the ids it holds and zeros the rest,
    and the rows are summed over the model axis (one non-zero term
    each); batch as ``ids`` rides the data axes."""
    if not is_dtensor(table):
        return table[ids]
    mesh = table.device_mesh
    names = mesh.mesh_dim_names or ()
    vocab_sharded = any(isinstance(p, Shard) and p.dim == 0 and
                        n == MODEL_AXIS
                        for n, p in zip(names, table.placements))
    tpl = tuple(Shard(0) if n == MODEL_AXIS and vocab_sharded
                else Replicate() for n in names)
    ipl = batch_and((ids,), Replicate())
    shape, offset = local_shape_offset(table.shape, mesh, tpl)
    v0, vl = offset[0], shape[0]

    def local(table, ids):
        rel = ids - v0
        mine = (rel >= 0) & (rel < vl)
        rows = table[torch.where(mine, rel, 0)]
        return torch.where(mine[..., None], rows, 0)

    out = tuple(Partial() if n == MODEL_AXIS and vocab_sharded else p
                for n, p in zip(names, ipl))
    # a rank's table gradient holds its own tokens' rows: a share of the
    # sum over the batch axes
    tgrad = tuple(Partial() if isinstance(ip, Shard) else tp
                  for tp, ip in zip(tpl, ipl))
    return run_local(local, out, (tpl, ipl), table, ids,
                     in_grad_placements=(tgrad, ipl))


def split_last(x, *shape):
    """``x.reshape(*x.shape[:-1], *shape)``: the last dim split into
    ``shape`` (heads, head width).  A DTensor sharded on that dim over
    more ranks than ``shape[0]`` splits into is first gathered on it
    (the heads-not-divisible case, where GSPMD replicates them too)."""
    if is_dtensor(x):
        last = x.ndim - 1
        n = 1
        for i, p in enumerate(x.placements):
            if isinstance(p, Shard) and p.dim == last:
                n *= x.device_mesh.size(i)
        if shape[0] % n:
            x = x.redistribute(x.device_mesh, tuple(
                Replicate() if isinstance(p, Shard) and p.dim == last else p
                for p in x.placements))
    return x.reshape(*x.shape[:-1], *shape)


def replicated_call(fn, n_out: int, *args):
    """``fn(*args)`` with every DTensor argument replicated and the
    ``n_out`` outputs replicated (the dispatch plan, which needs every
    token of its group)."""
    dt = next((a for a in args if is_dtensor(a)), None)
    if dt is None:
        return fn(*args)
    rep = replicated(dt.device_mesh)
    return run_local(fn, (rep,) * n_out if n_out > 1 else rep,
                     tuple(rep if isinstance(a, torch.Tensor) else None
                           for a in args), *args)


def expert_placements(x: DTensor, num_experts: int, dim: int) -> tuple:
    """Experts (tensor dim ``dim``) over ``model`` when it divides them,
    replicated over every other axis (the dispatch buffers' layout)."""
    mesh = x.device_mesh
    names = mesh.mesh_dim_names or ()
    shard = num_experts % model_size(mesh) == 0
    return tuple(Shard(dim) if n == MODEL_AXIS and shard else Replicate()
                 for n in names)


def partial_over_model(pl: tuple, names) -> tuple:
    """``pl`` with its ``Shard`` on the model axis made ``Partial()``: a
    sum over the model ranks' local results."""
    return tuple(Partial() if n == MODEL_AXIS and isinstance(p, Shard)
                 else p for n, p in zip(names, pl))
