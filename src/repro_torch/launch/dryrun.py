"""Multi-pod dry-run of the port: trace one step of every (arch x shape x
mesh) cell on the production mesh without a device.

Port of ``repro/launch/dryrun.py``.  JAX lowers and compiles each cell
for 256 (512) forced host devices; the port has no compiler to ask, so
each cell runs in its own process on ``torch.distributed``'s
single-process ``"fake"`` backend at 256 (512) ranks, under
``FakeTensorMode``: the model, its sharded state and its inputs are
fake DTensors (this rank's shard of each, laid out by
``launch.sharding``), and one train, prefill or decode step is traced
through the model's own code, on the torch ``chunked`` attention and
the plain dispatch plan (what XLA costs in JAX).  It shows that a
config x shape's specs are coherent on the production mesh and counts,
per device (rank 0, whose shards are as large as any), under JAX's keys:

* ``memory.argument_size_in_bytes``: the bytes of this rank's shards of
  the step's arguments (parameters, AdamW state, batch or cache);
* ``memory.output_size_in_bytes``: the bytes of the step's returned
  tensors that are not arguments (the port updates the parameters, the
  optimizer state and the cache in place);
* ``memory.temp_size_in_bytes``: the peak, over the step, of the bytes
  of the tensors its local ops made that are still alive (a tensor's
  bytes count from the op that made it until its last reference goes);
* ``flops``: ``2 * M * N * K`` of every local matrix product and
  attention op (``torch.utils.flop_counter``'s formulas), counted on
  the local ops DTensor runs, not on the global ops above it;
  elementwise ops are not counted;
* ``bytes_accessed``: the bytes every local compute op (views and
  collectives aside) reads and writes, each input and output once per
  op (no fusion);
* ``collectives.{bytes,counts,total_bytes}``: by kind, the output bytes
  and the number of the functional collectives DTensor issues
  (``all-gather``, ``all-reduce``, ``reduce-scatter``, ``all-to-all``);
* ``lower_s``: seconds to build the fake sharded state and inputs;
  ``compile_s``: seconds to trace the step (nothing is compiled).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  python -m repro_torch.launch.dryrun --all            # subprocess per cell
"""
import argparse
import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time
import weakref

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs import (ARCH_IDS, applicable_shapes, get_config,
                       get_smoke_config, shape_by_name)
from ..models import transformer as T
from ..models.dist import local_shape_offset
from ..models.layers import COMPUTE_DTYPE
from ..optim import OptConfig
from ..optim.adamw import layer_dims, leaf_ndim
from ..train.steps import make_decode_step, make_prefill_step, \
    make_train_step
from . import sharding as SH
from .mesh import make_production_mesh
from .specs import input_specs

_COLLECTIVES = {"all_gather": "all-gather", "all_reduce": "all-reduce",
                "reduce_scatter": "reduce-scatter",
                "all_to_all": "all-to-all"}

VARIANT_FLAGS = ("expert_fsdp", "master_bf16", "seqpar", "logits_bf16",
                 "moe_data", "moe_group")


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _LocalCount(TorchDispatchMode):
    """Counts the local ops under DTensor: it hands every op on DTensors
    back to DTensor (``NotImplemented``), which runs the op's local ops
    on plain (fake) tensors through this mode again.  The ops DTensor
    runs only to derive an output's global shape (``_in_meta``) are not
    counted."""

    def __init__(self, record_ops: bool = False):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll_bytes = dict.fromkeys(_COLLECTIVES.values(), 0)
        self.coll_counts = dict.fromkeys(_COLLECTIVES.values(), 0)
        self.live = {}                      # storage -> [bytes, holders]
        self.live_bytes = 0
        self.peak = 0
        self.ops = [] if record_ops else None

    def _hold(self, t: torch.Tensor) -> None:
        key = t.untyped_storage()._cdata
        if key not in self.live:
            self.live[key] = [t.untyped_storage().nbytes(), 0]
            self.live_bytes += self.live[key][0]
            self.peak = max(self.peak, self.live_bytes)
        self.live[key][1] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key) -> None:
        entry = self.live.get(key)
        if entry is None:
            return
        entry[1] -= 1
        if entry[1] == 0:
            self.live_bytes -= entry[0]
            del self.live[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if _in_meta[0]:
            return out
        name = func.__name__
        ns = func.namespace
        outs = [o for o in torch.utils._pytree.tree_leaves(out)
                if isinstance(o, torch.Tensor)]
        for o in outs:
            self._hold(o)
        if ns == "_c10d_functional":
            for key, kind in _COLLECTIVES.items():
                if name.startswith(key):
                    self.coll_bytes[kind] += sum(_nbytes(o) for o in outs)
                    self.coll_counts[kind] += 1
            return out
        if ns == "prim" or func.is_view:
            return out
        ins = [a for a in torch.utils._pytree.tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)]
        self.bytes += sum(_nbytes(t) for t in ins + outs)
        f = self.flop_registry.get(func._overloadpacket)
        if f is not None:
            self.flops += f(*args, **kwargs, out_val=out)
        if self.ops is not None:
            self.ops.append(f"{ns}.{name} "
                            f"{[tuple(t.shape) for t in ins]} -> "
                            f"{[tuple(t.shape) for t in outs]}")
        return out


_in_meta = [False]


@contextlib.contextmanager
def _no_meta_counts():
    """Mark the ops DTensor runs for an output's global shape."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    real = ShardingPropagator._propagate_tensor_meta_non_cached

    def wrapped(self, op_schema):
        _in_meta[0] = True
        try:
            return real(self, op_schema)
        finally:
            _in_meta[0] = False
    ShardingPropagator._propagate_tensor_meta_non_cached = wrapped
    try:
        yield
    finally:
        ShardingPropagator._propagate_tensor_meta_non_cached = real


# ---------------------------------------------------------------------------
# the fake mesh and the fake sharded state
# ---------------------------------------------------------------------------

def fake_group(world_size: int) -> None:
    """This process as rank 0 of a ``world_size``-rank fake group (a
    group of another size is torn down first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world_size:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_mesh(multi_pod: bool, mesh_shape=None):
    """The production mesh (16x16, 2x16x16) or ``mesh_shape`` over the
    same axes, on the fake group, and its label."""
    if mesh_shape is None:
        shape = (2, 16, 16) if multi_pod else (16, 16)
    else:
        shape = tuple(mesh_shape)
    fake_group(int(torch.Size(shape).numel()))
    if mesh_shape is None:
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    else:
        axes = ("pod", "data", "model") if len(shape) == 3 \
            else ("data", "model")
        mesh = init_device_mesh("cpu", shape, mesh_dim_names=axes)
    return mesh, "x".join(str(n) for n in shape)


def fake_dtensor(t: torch.Tensor, mesh, spec) -> DTensor:
    """This rank's shard of ``t`` (a ``meta`` or fake tensor) as a fake
    DTensor laid out by ``spec``; call under ``FakeTensorMode``."""
    pl = SH.placements(spec, mesh)
    shape, _ = local_shape_offset(t.shape, mesh, pl)
    local = torch.empty(shape, dtype=t.dtype, device="cpu")
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def _fake_tree(tree, mesh, specs):
    if isinstance(tree, dict):
        return {k: (_fake_tree(v, mesh, specs[k])
                    if isinstance(specs, dict) and k in specs else v)
                for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return fake_dtensor(tree, mesh, specs)
    return tree


def _fake_params(model, mesh, specs, requires_grad: bool):
    for name, p in list(model.named_parameters()):
        owner = model.get_submodule(name.rpartition(".")[0]) \
            if "." in name else model
        setattr(owner, name.rpartition(".")[2], torch.nn.Parameter(
            fake_dtensor(p, mesh, specs[name]),
            requires_grad=requires_grad))
    return model


def _local_bytes(tree) -> int:
    leaves = torch.utils._pytree.tree_leaves(tree)
    return sum(_nbytes(t.to_local() if isinstance(t, DTensor) else t)
               for t in leaves if isinstance(t, torch.Tensor))


def _cell_config(arch: str, multi_pod: bool, mesh, cfg_override, opts):
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    if "moe_group" in opts and cfg.moe is not None:
        groups = SH.axis_size(mesh, "data") * SH.axis_size(mesh, "pod")
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, dispatch_groups=groups))
    return cfg


def build(arch: str, shape_name: str, multi_pod: bool, mesh,
          cfg_override=None, opts: frozenset = frozenset()):
    """The step of one cell on ``mesh`` and its fake sharded arguments:
    ``(step, args)``; call under ``FakeTensorMode``."""
    for o in opts:
        assert o in VARIANT_FLAGS, o
    shape = shape_by_name(shape_name)
    cfg = _cell_config(arch, multi_pod, mesh, cfg_override, opts)
    shard_fn = SH.make_shard_fn(mesh, multi_pod,
                                seqpar="seqpar" in opts,
                                moe_data="moe_data" in opts)
    specs = input_specs(cfg, shape)
    T.set_logits_dtype(torch.bfloat16 if "logits_bf16" in opts
                       else torch.float32)
    train = shape.kind == "train"
    # train: float32 parameters (bf16 matrices under master_bf16), as JAX
    # trains; serve: the port's bf16 serving matrices
    model = T.init(cfg, generator=None, device="meta",
                   param_dtype=torch.float32 if train else COMPUTE_DTYPE)
    master = "master_bf16" in opts
    if train and master:
        stacked = layer_dims(model)
        for name, p in model.named_parameters():
            if leaf_ndim(name, p, stacked) > 1:
                p.data = p.data.to(COMPUTE_DTYPE)
    pspec = SH.param_specs(model, expert_fsdp="expert_fsdp" in opts)
    dp = SH.dp_axes_for(multi_pod, shape.global_batch)
    tok_spec = (dp, *([None] * (1 if cfg.num_codebooks == 1 else 2)))
    _fake_params(model, mesh, pspec, requires_grad=train)
    if train:
        named = dict(model.named_parameters())
        opt = {"mu": {n: torch.empty(p.shape, device="meta")
                      for n, p in named.items()},
               "nu": {n: torch.empty(p.shape, device="meta")
                      for n, p in named.items()},
               "step": torch.empty((), dtype=torch.int32, device="meta")}
        if master:
            opt["master"] = {n: torch.empty(p.shape, device="meta")
                             for n, p in named.items()}
        opt = _fake_tree(opt, mesh, SH.opt_specs(pspec, master))
        batch = _fake_tree(specs, mesh, SH.batch_specs(
            multi_pod, cfg.num_codebooks, with_prefix=cfg.prefix_len > 0,
            global_batch=shape.global_batch))
        step = make_train_step(cfg, OptConfig(master_weights=master),
                               shard_fn)
        return step, (model, opt, batch)
    cspec = SH.cache_specs(cfg, multi_pod, shape.global_batch,
                           shape.seq_len, SH.axis_size(mesh, "model"))
    cache = _fake_tree(specs["cache"], mesh, cspec)
    if shape.kind == "prefill":
        toks = fake_dtensor(specs["tokens"], mesh, tok_spec)
        step = make_prefill_step(cfg, shard_fn, attn_impl="chunked",
                                 use_pallas_dispatch=False)
    else:
        toks = fake_dtensor(specs["token"], mesh, tok_spec)
        step = make_decode_step(cfg, shard_fn, attn_impl="chunked",
                                use_pallas_dispatch=False)
    return step, (model, toks, cache)


def trace_cell(arch: str, shape_name: str, multi_pod: bool,
               cfg_override=None, opts: frozenset = frozenset(),
               mesh_shape=None, record_ops: bool = False) -> dict:
    """Build and trace one cell; the per-device counts (module
    docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    t0 = time.time()
    mesh, label = make_mesh(multi_pod, mesh_shape)
    with FakeTensorMode(allow_non_fake_inputs=True):
        step, args = build(arch, shape_name, multi_pod, mesh, cfg_override,
                           opts)
        arg_bytes = _local_bytes([dict(args[0].named_parameters()),
                                  *args[1:]])
        t_lower = time.time() - t0
        count = _LocalCount(record_ops)
        with _no_meta_counts(), count:
            out = step(*args)
        t_compile = time.time() - t0 - t_lower
        held = {t.to_local().untyped_storage()._cdata
                for t in torch.utils._pytree.tree_leaves(
                    [dict(args[0].named_parameters()), *args[1:]])
                if isinstance(t, DTensor)}
        out_bytes = sum(
            _nbytes(t.to_local() if isinstance(t, DTensor) else t)
            for t in torch.utils._pytree.tree_leaves(out)
            if isinstance(t, torch.Tensor) and not isinstance(
                t, torch.nn.Parameter) and (t.to_local() if isinstance(
                    t, DTensor) else t).untyped_storage()._cdata not in held)
    T.set_logits_dtype(torch.float32)
    total = int(torch.Size(mesh.mesh.shape).numel())
    return {
        "mesh": label, "devices": total,
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
        "memory": {"argument_size_in_bytes": arg_bytes,
                   "output_size_in_bytes": out_bytes,
                   "temp_size_in_bytes": count.peak,
                   "generated_code_size_in_bytes": 0},
        "flops": float(count.flops),
        "bytes_accessed": float(count.bytes),
        "collectives": {"bytes": count.coll_bytes,
                        "counts": count.coll_counts,
                        "total_bytes": sum(count.coll_bytes.values())},
        "ops": count.ops,
    }


def _tag(arch, shape_name, mesh_label, opts, smoke: bool) -> str:
    suffix = ("__" + "-".join(sorted(opts))) if opts else ""
    return f"{arch}{'-smoke' if smoke else ''}__{shape_name}__{mesh_label}" \
        + suffix


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: str | None = None, save_hlo: bool = False,
             opts: frozenset = frozenset(), smoke: bool = False,
             mesh_shape=None) -> dict:
    """Trace one cell; write ``<tag>.json`` (and, with ``save_hlo``, the
    traced local op list ``<tag>.ops``) into ``out_dir``."""
    cfg = get_smoke_config(arch) if smoke else None
    r = trace_cell(arch, shape_name, multi_pod, cfg, opts, mesh_shape,
                   record_ops=save_hlo)
    ops = r.pop("ops")
    result = {"arch": arch, "shape": shape_name, "mesh": r["mesh"],
              "opts": sorted(opts), "smoke": smoke, **r, "ok": True}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = _tag(arch, shape_name, r["mesh"], opts, smoke)
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)
        if save_hlo:
            with open(os.path.join(out_dir, tag + ".ops"), "w") as f:
                f.write("\n".join(ops) + "\n")
    return result


def _cost_point(arch, shape_name, multi_pod, num_layers,
                opts: frozenset = frozenset(), base_cfg=None,
                mesh_shape=None):
    """(flops, bytes, collective_bytes) per device of a reduced-depth
    twin: one point of the linear-in-L model."""
    cfg = base_cfg if base_cfg is not None else get_config(arch)
    cfg = dataclasses.replace(cfg, num_layers=num_layers)
    r = trace_cell(arch, shape_name, multi_pod, cfg, opts, mesh_shape)
    return (r["flops"], r["bytes_accessed"],
            float(r["collectives"]["total_bytes"]))


def cost_extract(arch: str, shape_name: str, multi_pod: bool,
                 out_dir: str | None = None,
                 opts: frozenset = frozenset(), smoke: bool = False,
                 mesh_shape=None) -> dict:
    """Two-point linear extrapolation of per-device FLOPs / bytes /
    collective bytes to the full layer count, JAX's form.  The port's
    layers are a Python loop and its counts see every layer, so the
    extrapolation equals the full-depth count (a test holds them)."""
    cfg = get_smoke_config(arch) if smoke else get_config(arch)
    if cfg.family == "hybrid":
        l1, l2 = cfg.attn_every, 2 * cfg.attn_every
    else:
        l1, l2 = 1, 2
    f1, b1, c1 = _cost_point(arch, shape_name, multi_pod, l1, opts, cfg,
                             mesh_shape)
    f2, b2, c2 = _cost_point(arch, shape_name, multi_pod, l2, opts, cfg,
                             mesh_shape)
    n = cfg.num_layers
    per_layer = ((f2 - f1) / (l2 - l1), (b2 - b1) / (l2 - l1),
                 (c2 - c1) / (l2 - l1))
    base = (f1 - per_layer[0] * l1, b1 - per_layer[1] * l1,
            c1 - per_layer[2] * l1)
    _, label = make_mesh(multi_pod, mesh_shape)
    result = {
        "arch": arch, "shape": shape_name, "mesh": label,
        "opts": sorted(opts), "smoke": smoke,
        "flops_per_device": base[0] + per_layer[0] * n,
        "hbm_bytes_per_device": base[1] + per_layer[1] * n,
        "collective_bytes_per_device": base[2] + per_layer[2] * n,
        "points": {"l": [l1, l2], "flops": [f1, f2],
                   "bytes": [b1, b2], "coll": [c1, c2]},
    }
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        tag = _tag(arch, shape_name, label, opts, smoke) + "__cost"
        with open(os.path.join(out_dir, tag + ".json"), "w") as f:
            json.dump(result, f, indent=1)
    return result


def all_cells():
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in applicable_shapes(cfg):
            yield arch, shape.name


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--save-hlo", action="store_true",
                    help="save the traced local op list (<tag>.ops), the "
                         "port's stand-in for JAX's HLO text")
    ap.add_argument("--cost-extract", action="store_true",
                    help="extrapolated roofline terms instead of the "
                         "full-depth trace")
    ap.add_argument("--opts", default="",
                    help="comma-separated variant flags: "
                         + ",".join(VARIANT_FLAGS))
    args = ap.parse_args()
    opts = frozenset(o for o in args.opts.split(",") if o)

    if args.all:
        failures = []
        for arch, shape in all_cells():
            for mp in ([False, True] if args.both_meshes
                       else [args.multi_pod]):
                tag = f"{arch} {shape} {'2x16x16' if mp else '16x16'}"
                cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                       "--arch", arch, "--shape", shape, "--out", args.out]
                if mp:
                    cmd.append("--multi-pod")
                if args.save_hlo:
                    cmd.append("--save-hlo")
                if args.cost_extract:
                    cmd.append("--cost-extract")
                if args.opts:
                    cmd += ["--opts", args.opts]
                t0 = time.time()
                r = subprocess.run(cmd, capture_output=True, text=True)
                ok = r.returncode == 0
                print(f"[{'OK' if ok else 'FAIL'}] {tag} "
                      f"({time.time() - t0:.0f}s)", flush=True)
                if not ok:
                    failures.append((tag, r.stderr[-2000:]))
        if failures:
            for tag, err in failures:
                print("FAILED:", tag, "\n", err)
            sys.exit(1)
        return

    if args.cost_extract:
        res = cost_extract(args.arch, args.shape, args.multi_pod, args.out,
                           opts=opts)
        print(json.dumps(res), flush=True)
        return
    res = run_cell(args.arch, args.shape, args.multi_pod, args.out,
                   args.save_hlo, opts=opts)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
