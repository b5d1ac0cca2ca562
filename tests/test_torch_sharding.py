"""Port parity of the sharding rules (``repro_torch.launch.sharding``)
against ``repro.launch.sharding``: parameter, optimizer, batch and cache
specs of every arch (SMOKE and full), each port parameter's spec equal
to JAX's leaf spec without the leaf's layer-stack dims; every branch of
``make_shard_fn`` as DTensor placements on a fake-backend mesh; the
distributed bootstrap's environment parsing and ``global_batch_slice`` on
a 2-rank gloo group."""
import os
import subprocess
import sys
import textwrap
from functools import partial

import jax
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro.configs import ARCH_IDS
from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch import sharding as JSH
from repro.models import transformer as jt
from repro_torch import configs as tconfigs
from repro_torch.launch import distributed_init as DI
from repro_torch.launch import sharding as SH
from repro_torch.models import transformer as tt
from repro_torch.models.convert import _jax_path

SIZES = {"smoke": (jax_smoke, tconfigs.get_smoke_config),
         "full": (jax_config, tconfigs.get_config)}


def _jax_specs(jcfg, expert_fsdp):
    shapes = jax.eval_shape(partial(jt.init, cfg=jcfg),
                            jax.random.PRNGKey(0))
    specs = JSH.param_specs(shapes, expert_fsdp=expert_fsdp)
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {tuple(str(getattr(k, "key", k)) for k in path): tuple(spec)
            for path, spec in flat}


@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_jax(arch, size):
    """Every port parameter's spec is JAX's leaf spec without the leaf's
    leading layer-stack dims, for both ``expert_fsdp`` values; every JAX
    leaf has its parameters."""
    jget, tget = SIZES[size]
    jcfg, tcfg = jget(arch), tget(arch)
    model = tt.init(tcfg, generator=None, device="meta")
    lead = tt.layer_stack(tcfg)
    for expert_fsdp in (False, True):
        want = _jax_specs(jcfg, expert_fsdp)
        got = SH.param_specs(model, expert_fsdp=expert_fsdp)
        seen = set()
        for name, p in model.named_parameters():
            path, row = _jax_path(name, lead)
            stack = 0 if row is None else len(row)
            assert got[name] == want[path][stack:], (name, expert_fsdp)
            assert len(got[name]) == p.ndim, name
            seen.add(path)
        assert seen == set(want)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_batch_opt_specs_match_jax(arch):
    """``cache_specs`` (model axis 16; ``seq_len`` 0 and 32768, global
    batch 0 and 128, one and two pods), ``batch_specs``, ``dp_axes_for``
    and ``opt_specs`` equal JAX's; the port's cache has no spec for its
    host-int index."""
    for size, (jget, tget) in SIZES.items():
        jcfg, tcfg = jget(arch), tget(arch)
        for multi_pod in (False, True):
            for gb in (0, 128):
                for seq in (0, 32768):
                    want = JSH.cache_specs(jcfg, multi_pod, gb, seq, 16)
                    got = SH.cache_specs(tcfg, multi_pod, gb, seq, 16)
                    assert "index" not in got
                    assert set(got) == set(want) - {"index"}
                    for part, ts in got.items():
                        assert set(ts) == set(want[part])
                        for n, spec in ts.items():
                            assert spec == tuple(want[part][n]), (part, n)
    for multi_pod in (False, True):
        for gb in (0, 1, 16, 32, 128, 256):
            assert SH.dp_axes_for(multi_pod, gb) == \
                JSH.dp_axes_for(multi_pod, gb)
            for ncb in (1, 4):
                for prefix in (False, True):
                    want = JSH.batch_specs(multi_pod, ncb, prefix, gb)
                    got = SH.batch_specs(multi_pod, ncb, prefix, gb)
                    assert got == {k: tuple(v) for k, v in want.items()}
    tcfg = tconfigs.get_smoke_config(arch)
    pspec = SH.param_specs(tt.init(tcfg, generator=None, device="meta"))
    for master in (False, True):
        got = SH.opt_specs(pspec, master)
        assert got["step"] == () and got["mu"] is pspec and \
            got["nu"] is pspec
        assert ("master" in got) == master


# ---- make_shard_fn and placements on a fake-backend mesh ----------------------

@pytest.fixture
def fake_meshes():
    """(2, 2) over (data, model) and (2, 2, 2) over (pod, data, model) on
    the single-process fake backend (placements only: its collectives
    move no data)."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield {False: init_device_mesh("cpu", (2, 2),
                                       mesh_dim_names=("data", "model")),
               True: init_device_mesh("cpu", (2, 2, 2),
                                      mesh_dim_names=("pod", "data",
                                                      "model"))}
    finally:
        dist.destroy_process_group()


def _dt(mesh, shape):
    t = torch.zeros(shape)
    return DTensor.from_local(t, mesh, (Replicate(),) * mesh.ndim,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


R, S0, S1, S2 = Replicate(), Shard(0), Shard(1), Shard(2)
# (name, shape, make_shard_fn kwargs, placements on (data, model), or
# None where JAX returns x unconstrained); one case per branch of
# repro/launch/sharding.py make_shard_fn
SHARD_FN_CASES = [
    ("moe_tok", (4, 6, 8), {}, (S0, R)),             # groups ride data
    ("moe_tok", (3, 6, 8), {}, None),                # not divisible
    ("moe_tok", (1, 6, 8), {}, None),                # one group
    ("moe_buf", (4, 8, 5, 8), {}, (S0, S1)),         # grouped, G over data
    ("moe_buf", (1, 8, 5, 8), {}, (R, S1)),          # one group
    ("moe_buf", (3, 8, 5, 8), {}, None),             # G not divisible
    ("moe_buf", (8, 6, 8), {"moe_data": True}, (S1, S0)),  # capacity on data
    ("moe_buf", (8, 5, 8), {"moe_data": True}, None),
    ("moe_buf", (8, 6, 8), {}, None),                # ungrouped, no moe_data
    ("resid", (4, 6, 8), {"seqpar": True}, (S0, S1)),  # sequence parallel
    ("resid", (4, 1, 8), {"seqpar": True}, (S0, R)),   # one position
    ("resid", (4, 6, 8), {}, (S0, R)),
    ("hidden", (4, 6, 2, 8), {}, (S0, R)),           # ndim >= 3
    ("hidden", (4, 8), {}, (S0, R)),                 # (dp, None)
    ("resid", (4, 6, 8), {"dp_override": None}, (R, R)),
]


@pytest.mark.parametrize("case", range(len(SHARD_FN_CASES)))
def test_make_shard_fn_branches(fake_meshes, case):
    name, shape, kw, want = SHARD_FN_CASES[case]
    mesh = fake_meshes[False]
    x = _dt(mesh, shape)
    got = SH.make_shard_fn(mesh, False, **kw)(name, x)
    if want is None:
        assert got is x
    else:
        assert tuple(got.placements) == want and got.shape == x.shape
    plain = torch.zeros(shape)
    assert SH.make_shard_fn(mesh, False, **kw)(name, plain) is plain


def test_multi_pod_specs_shard_over_pod_and_data(fake_meshes):
    """``("pod", "data")`` on one dim shards it over both axes."""
    mesh = fake_meshes[True]
    x = _dt(mesh, (8, 6, 8))
    got = SH.make_shard_fn(mesh, True)("resid", x)
    assert tuple(got.placements) == (S0, S0, R)
    assert SH.placements((("pod", "data"), None, "model"), mesh) == \
        (S0, S0, S2)
    with pytest.raises(ValueError):
        SH.placements(("pod", None), fake_meshes[False])


def test_distribute_params_lays_out_by_spec(fake_meshes):
    """``distribute_params`` gives each parameter its spec's placements
    and keeps ``requires_grad``; ``distribute_tree`` keeps a host int."""
    mesh = fake_meshes[False]
    cfg = tconfigs.get_smoke_config("deepseek-moe-16b")
    model = tt.init(cfg, generator=torch.Generator().manual_seed(0),
                    device="cpu", param_dtype=torch.float32)
    model.requires_grad_()
    specs = SH.param_specs(model)
    SH.distribute_params(model, mesh, specs)
    for name, p in model.named_parameters():
        assert isinstance(p, DTensor) and p.requires_grad, name
        assert tuple(p.placements) == SH.placements(specs[name], mesh)
    cache = tt.zeros_cache(cfg, 4, 8, device="cpu")
    dc = SH.distribute_tree(cache, mesh, SH.cache_specs(cfg, False, 0, 8, 2))
    assert dc["index"] == 0
    assert tuple(dc["kv"]["k"].placements) == (S1, Shard(3))


# ---- distributed bootstrap -----------------------------------------------------

def test_coordinator_from_env():
    assert DI.coordinator_from_env({}) is None
    assert DI.coordinator_from_env({"REPRO_COORDINATOR": "h:1234",
                                    "REPRO_NUM_PROCESSES": "4",
                                    "REPRO_PROCESS_ID": "2"}) == ("h:1234",
                                                                  4, 2)
    env = {"SLURM_JOB_NODELIST": "node[01-04],gpu7", "SLURM_NTASKS": "8",
           "SLURM_PROCID": "5"}
    assert DI.coordinator_from_env(env) == ("node:8476", 8, 5)
    env["SLURM_NODELIST_SUFFIX"] = "01"
    assert DI.coordinator_from_env(env)[0] == "node01:8476"
    env["REPRO_COORDINATOR"] = "c:1"
    assert DI.coordinator_from_env(env) == ("c:1", 8, 5)
    assert DI.coordinator_from_env({"REPRO_COORDINATOR": "h:1"}) == \
        ("h:1", 1, 0)


def test_maybe_initialize_without_coordinator(monkeypatch):
    for k in ("REPRO_COORDINATOR", "SLURM_JOB_NODELIST"):
        monkeypatch.delenv(k, raising=False)
    assert DI.maybe_initialize_distributed(device="cpu") is False
    assert DI.global_batch_slice(8) == slice(0, 8)


RANK_SCRIPT = textwrap.dedent("""
    import os, socket, sys
    import torch.distributed as dist
    from repro_torch.launch import distributed_init as DI
    assert DI.maybe_initialize_distributed(device="cpu")
    assert dist.get_backend() == "gloo" and dist.get_world_size() == 2
    s = DI.global_batch_slice(8)
    print("SLICE", dist.get_rank(), s.start, s.stop, flush=True)
    try:
        DI.global_batch_slice(7)
    except AssertionError:
        print("ASSERT", dist.get_rank(), flush=True)
    dist.barrier()
    dist.destroy_process_group()
""")


def test_global_batch_slice_on_two_gloo_ranks():
    """Two processes join through ``maybe_initialize_distributed`` (the
    ``REPRO_*`` environment, gloo on the CPU, a localhost coordinator)
    and own rows 0-3 and 4-7 of a batch of 8; 7 rows do not split."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    src = os.path.join(os.path.dirname(__file__), "..", "src")
    procs = []
    for rank in range(2):
        env = dict(os.environ, REPRO_COORDINATOR=f"127.0.0.1:{port}",
                   REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID=str(rank),
                   PYTHONPATH=os.path.abspath(src))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", RANK_SCRIPT], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-2000:]
    lines = sorted(ln for out, _ in outs for ln in out.splitlines())
    assert lines == ["ASSERT 0", "ASSERT 1", "SLICE 0 0 4", "SLICE 1 4 8"]
