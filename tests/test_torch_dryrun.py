"""The port's dry-run (``repro_torch.launch.dryrun``): SMOKE
deepseek-moe-16b cells of each step kind (train_4k, prefill_32k,
decode_32k) on the ``(1, 1)``, ``(2, 2)`` and production ``16x16``
meshes, traced on the single-process fake backend under
``FakeTensorMode``, each group of cells in a subprocess of its own (a
process group is process-global).  Held: JAX's keys are present and
``scripts/summarize_dryrun.py`` reads the output directory; the
argument bytes per device equal the specs' own sum (shard shapes from
DTensor's ``compute_local_shape_and_global_offset``); on ``(1, 1)`` no
collective and the FLOPs of the unsharded step under ``FlopCounterMode``;
a ``(1, 2)`` train step all-reduces or reduce-scatters; ``cost_extract``'s
two-point extrapolation equals the direct full-depth count (the port
sees every layer, so JAX's ``unroll`` has no counterpart); each of
JAX's six ``VARIANT_FLAGS`` traces, and so does the 2x16x16 mesh."""
import json
import os
import subprocess
import sys
import textwrap

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SHAPES = ("train_4k", "prefill_32k", "decode_32k")
MESHES = {"1x1": (1, 1), "2x2": (2, 2), "16x16": None}
ARCH = "deepseek-moe-16b"

HELPER = textwrap.dedent('''
    import json, sys
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor._utils import \\
        compute_local_shape_and_global_offset
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.configs import get_smoke_config, shape_by_name
    from repro_torch.launch import dryrun, sharding as SH
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import transformer as T
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import steps

    ARCH, out_dir, job = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    res = {}

    def spec_bytes(shape_name, mesh_shape):
        """The step's argument bytes per device from the specs alone."""
        cfg = get_smoke_config(ARCH)
        shape = shape_by_name(shape_name)
        mesh, _ = dryrun.make_mesh(False, mesh_shape)
        train = shape.kind == "train"
        model = T.init(cfg, generator=None, device="meta",
                       param_dtype=torch.float32 if train else torch.bfloat16)
        pspec = SH.param_specs(model)

        def nb(shape, dtype, spec):
            local, _ = compute_local_shape_and_global_offset(
                shape, mesh, SH.placements(spec, mesh))
            return torch.Size(local).numel() * torch.empty(
                (), dtype=dtype).element_size()
        total = sum(nb(p.shape, p.dtype, pspec[n])
                    for n, p in model.named_parameters())
        specs = input_specs(cfg, shape)
        dp = SH.dp_axes_for(False, shape.global_batch)
        if train:
            total += 2 * sum(nb(p.shape, torch.float32, pspec[n])
                             for n, p in model.named_parameters())
            total += nb((), torch.int32, ())
            bs = SH.batch_specs(False, 1, global_batch=shape.global_batch)
            total += sum(nb(t.shape, t.dtype, bs[k]) for k, t in specs.items())
            return total
        cs = SH.cache_specs(cfg, False, shape.global_batch, shape.seq_len,
                            SH.axis_size(mesh, "model"))
        for part, ts in specs["cache"].items():
            if part != "index":
                total += sum(nb(t.shape, t.dtype, cs[part][n])
                             for n, t in ts.items())
        tok = specs.get("tokens", specs.get("token"))
        return total + nb(tok.shape, tok.dtype, (dp, None))

    def unsharded_flops(shape_name):
        """FlopCounterMode's count of the unsharded step, fake tensors."""
        cfg = get_smoke_config(ARCH)
        shape = shape_by_name(shape_name)
        train = shape.kind == "train"
        with FakeTensorMode():
            model = T.init(cfg, generator=None, device="meta",
                           param_dtype=torch.float32 if train
                           else torch.bfloat16)
            for name, p in list(model.named_parameters()):
                owner = model.get_submodule(name.rpartition(".")[0]) \\
                    if "." in name else model
                setattr(owner, name.rpartition(".")[2], torch.nn.Parameter(
                    torch.empty(p.shape, dtype=p.dtype), requires_grad=train))
            specs = input_specs(cfg, shape)
            fake = lambda t: torch.empty(t.shape, dtype=t.dtype)
            with FlopCounterMode(display=False) as fc:
                if train:
                    batch = {k: fake(t) for k, t in specs.items()}
                    steps.make_train_step(cfg, OptConfig())(
                        model, adamw_init(model), batch)
                else:
                    cache = {p: ({n: fake(t) for n, t in ts.items()}
                                 if p != "index" else ts)
                             for p, ts in specs["cache"].items()}
                    kw = dict(attn_impl="chunked", use_pallas_dispatch=False)
                    if shape.kind == "prefill":
                        steps.make_prefill_step(cfg, **kw)(
                            model, fake(specs["tokens"]), cache)
                    else:
                        steps.make_decode_step(cfg, **kw)(
                            model, fake(specs["token"]), cache)
        return fc.get_total_flops()

    for mesh_label, mesh_shape in job.get("cells", []):
        for shape_name in job["shapes"]:
            r = dryrun.run_cell(ARCH, shape_name, False, out_dir,
                                smoke=True, mesh_shape=mesh_shape)
            r["spec_bytes"] = spec_bytes(shape_name, mesh_shape)
            res[f"{mesh_label}/{shape_name}"] = r
    for opt in job.get("opts", []):
        r = dryrun.run_cell(ARCH, "train_4k", False, smoke=True,
                            mesh_shape=[2, 2], opts=frozenset([opt]))
        res[f"opt/{opt}"] = r
    if job.get("multi_pod"):
        res["multi_pod"] = dryrun.run_cell(ARCH, "decode_32k", True,
                                           smoke=True)
    for shape_name in job.get("unsharded", []):
        res[f"unsharded/{shape_name}"] = unsharded_flops(shape_name)
    if job.get("cost"):
        arch, shape_name, mesh_shape = job["cost"]
        cfg = get_smoke_config(arch)
        res["cost"] = dryrun.cost_extract(arch, shape_name, False,
                                          smoke=True, mesh_shape=mesh_shape)
        res["direct"] = dryrun.trace_cell(arch, shape_name, False, cfg,
                                          mesh_shape=mesh_shape)
        res["direct"].pop("ops")
        res["layers"] = cfg.num_layers
    print("RESULT " + json.dumps(res), flush=True)
''')

JOBS = [
    {"cells": [["1x1", [1, 1]]], "shapes": SHAPES, "unsharded": SHAPES},
    {"cells": [["2x2", [2, 2]]], "shapes": SHAPES,
     "cost": ["llama3-8b", "decode_32k", [2, 2]]},
    {"cells": [["16x16", None]], "shapes": SHAPES},
    {"cells": [["1x2", [1, 2]]], "shapes": ["train_4k"], "multi_pod": True},
    {"opts": ["expert_fsdp", "master_bf16", "seqpar"]},
    {"opts": ["logits_bf16", "moe_data", "moe_group"]},
]


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """(results by ``mesh/shape``, the output directory), from the jobs'
    subprocesses, all started together."""
    out = tmp_path_factory.mktemp("dryrun")
    script = out / "helper.py"
    script.write_text(HELPER)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, str(script), ARCH, str(out / "cells"),
         json.dumps(job)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for job in JOBS]
    res = {}
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-4000:]
            line = [ln for ln in stdout.splitlines()
                    if ln.startswith("RESULT ")][-1]
            res.update(json.loads(line[len("RESULT "):]))
    finally:
        for p in procs:
            p.kill()
    return res, out / "cells"


JAX_KEYS = ("arch", "shape", "mesh", "opts", "devices", "lower_s",
            "compile_s", "memory", "flops", "bytes_accessed", "collectives",
            "ok")


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("shape", SHAPES)
def test_cell_keys_and_argument_bytes(cells, mesh, shape):
    res, _ = cells
    r = res[f"{mesh}/{shape}"]
    for k in JAX_KEYS:
        assert k in r, k
    assert r["ok"] and r["mesh"] == mesh
    assert r["devices"] == {"1x1": 1, "2x2": 4, "16x16": 256}[mesh]
    for k in ("argument_size_in_bytes", "output_size_in_bytes",
              "temp_size_in_bytes"):
        assert r["memory"][k] >= 0
    assert r["memory"]["argument_size_in_bytes"] == r["spec_bytes"]
    assert r["flops"] > 0 and r["bytes_accessed"] > 0
    coll = r["collectives"]
    assert set(coll["bytes"]) == set(coll["counts"]) == {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    assert coll["total_bytes"] == sum(coll["bytes"].values())


@pytest.mark.parametrize("shape", SHAPES)
def test_one_device_has_no_collectives_and_the_unsharded_flops(cells, shape):
    res, _ = cells
    r = res[f"1x1/{shape}"]
    assert r["collectives"]["total_bytes"] == 0
    assert not any(r["collectives"]["counts"].values())
    assert r["flops"] == res[f"unsharded/{shape}"]


def test_sharded_cells_divide_the_work(cells):
    """Per-device FLOPs and argument bytes fall as the mesh grows, and a
    mesh with a model axis moves bytes."""
    res, _ = cells
    for shape in SHAPES:
        one, four = res[f"1x1/{shape}"], res[f"2x2/{shape}"]
        assert four["flops"] < one["flops"]
        assert four["memory"]["argument_size_in_bytes"] < \
            one["memory"]["argument_size_in_bytes"]
        assert four["collectives"]["total_bytes"] > 0


def test_model_axis_reduces(cells):
    res, _ = cells
    counts = res["1x2/train_4k"]["collectives"]["counts"]
    assert counts["all-reduce"] + counts["reduce-scatter"] > 0


def test_cost_extract_equals_the_full_depth_count(cells):
    """llama3-8b SMOKE (3 layers) decode on (2, 2): the two-point
    extrapolation from 1 and 2 layers equals the 3-layer trace."""
    res, _ = cells
    cost, direct = res["cost"], res["direct"]
    assert res["layers"] == 3 and cost["points"]["l"] == [1, 2]
    for key, want in (("flops_per_device", direct["flops"]),
                      ("hbm_bytes_per_device", direct["bytes_accessed"]),
                      ("collective_bytes_per_device",
                       direct["collectives"]["total_bytes"])):
        assert cost[key] == pytest.approx(want, rel=1e-12, abs=0), key
    assert cost["mesh"] == "2x2"


@pytest.mark.parametrize("opt", ["expert_fsdp", "master_bf16", "seqpar",
                                 "logits_bf16", "moe_data", "moe_group"])
def test_variant_flags_trace(cells, opt):
    """Each of JAX's ``VARIANT_FLAGS`` traces a SMOKE train cell on ``(2,
    2)``: the layouts they name hold (expert FSDP shrinks the arguments,
    bf16 parameters with float32 masters grow them, 12 -> 14 bytes a
    parameter; the others keep them)."""
    res, _ = cells
    base, r = res["2x2/train_4k"], res[f"opt/{opt}"]
    assert r["ok"] and r["opts"] == [opt] and r["flops"] > 0
    args, want = (r["memory"]["argument_size_in_bytes"],
                  base["memory"]["argument_size_in_bytes"])
    if opt == "expert_fsdp":
        assert args < want
    elif opt == "master_bf16":
        assert want < args < want * 14 / 12 + 64
    else:
        assert args == want
    assert r["collectives"]["total_bytes"] > 0


def test_multi_pod_mesh(cells):
    res, _ = cells
    r = res["multi_pod"]
    assert r["ok"] and r["mesh"] == "2x16x16" and r["devices"] == 512


def test_summarize_dryrun_reads_the_output(cells):
    _, out = cells
    files = [f for f in os.listdir(out) if f.endswith(".json")]
    assert len(files) == 10
    r = subprocess.run([sys.executable, os.path.join(ROOT, "scripts",
                                                     "summarize_dryrun.py"),
                        str(out)], capture_output=True, text=True,
                       timeout=60)
    assert r.returncode == 0, r.stderr
    assert "10 cells, all compiled OK." in r.stdout
    assert r.stdout.count(f"| {ARCH} |") == 10
