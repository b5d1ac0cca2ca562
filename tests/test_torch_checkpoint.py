"""Checkpointing of the port (``repro_torch.checkpoint``) in the JAX
package's on-disk format, and the trainer's restart
(``repro_torch.launch.train``).

The cases of tests/test_checkpoint.py (round trip, a directory without a
manifest ignored, a template shape mismatch refused, elastic restore:
here onto the template's device, the card in tests/test_torch_cuda.py),
the async writer's copy, a float32 train state across packages in both
directions (the next step's loss matching), bf16 leaves (restored in the
port by their bits; JAX's ``restore_checkpoint`` cannot cast them, a
standing difference, ROADMAP.md Queue 3), and a trainer run killed after
its step-6 checkpoint and resumed to step 10, bitwise the uninterrupted
run."""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import restore_checkpoint as jax_restore
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_smoke_config as jax_smoke
from repro.optim import OptConfig as JOptConfig
from repro.train import steps as jsteps
from repro_torch import configs as tconfigs
from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.core import host
from repro_torch.data import SyntheticDataset
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.optim import OptConfig
from repro_torch.train import steps as tsteps


def tree_leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from tree_leaves(v, prefix + (k,))
        else:
            yield "/".join(prefix + (k,)), v


def as_bits(x) -> np.ndarray:
    """A leaf's bytes as unsigned integers (bf16, float32 and ints
    alike), for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.numpy()
    x = np.ascontiguousarray(np.asarray(x))
    return x.view(f"u{x.dtype.itemsize}")


def assert_trees_bitwise(a, b):
    la, lb = dict(tree_leaves(a)), dict(tree_leaves(b))
    assert sorted(la) == sorted(lb)
    for k in la:
        assert tuple(np.shape(la[k])) == tuple(np.shape(lb[k])), k
        np.testing.assert_array_equal(as_bits(la[k]), as_bits(lb[k]),
                                      err_msg=k)


def sample_tree():
    g = torch.Generator().manual_seed(0)
    return {"params": {"w": torch.randn(8, 16, generator=g),
                       "layers": {"wq": torch.randn(3, 4, 5, generator=g)
                                  .bfloat16()}},
            "opt": {"step": torch.tensor(11, dtype=torch.int32),
                    "mu": {"w": torch.zeros(8, 16)}},
            "host": np.arange(6, dtype=np.int64).reshape(2, 3)}


# ---- the cases of tests/test_checkpoint.py -------------------------------------

def test_round_trip(tmp_path):
    """Tensors (float32, bf16, an int32 scalar) and numpy leaves: the
    manifest records the keys as JAX's ``/``-joined paths and the global
    shapes; restore returns each leaf as its template's kind, bitwise."""
    tree = sample_tree()
    path = save_checkpoint(str(tmp_path), 11, tree, extra={"arch": "x"})
    assert os.path.basename(path) == "step_00000011"
    assert not os.path.exists(path + ".tmp")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        man = json.load(f)
    assert man["keys"] == ["host", "opt/mu/w", "opt/step", "params/layers/wq",
                           "params/w"]
    assert man["shapes"]["params/layers/wq"] == [3, 4, 5]
    assert man["shapes"]["opt/step"] == []
    assert latest_step(str(tmp_path)) == 11
    back, man = restore_checkpoint(str(tmp_path), 11, tree)
    assert man["step"] == 11 and man["extra"] == {"arch": "x"}
    assert back["params"]["layers"]["wq"].dtype == torch.bfloat16
    assert isinstance(back["host"], np.ndarray)
    assert_trees_bitwise(back, tree)
    # numpy leaves as written: bf16 as its 16-bit pattern
    with np.load(os.path.join(path, "shard_0.npz")) as z:
        assert z["params/layers/wq"].dtype == np.dtype("V2")
        assert z["params/w"].dtype == np.float32


def test_manifestless_step_dir_ignored(tmp_path):
    tree = {"a": torch.arange(4)}
    save_checkpoint(str(tmp_path), 5, tree)
    crashed = os.path.join(str(tmp_path), "step_00000009")
    os.makedirs(crashed)
    np.savez(os.path.join(crashed, "shard_0.npz"), a=np.arange(4))
    os.makedirs(os.path.join(str(tmp_path), "step_00000012.tmp"))
    assert latest_step(str(tmp_path)) == 5
    assert latest_step(str(tmp_path / "missing")) is None
    restored, _ = restore_checkpoint(str(tmp_path), 5, tree)
    assert torch.equal(restored["a"], tree["a"])


def test_template_shape_mismatch_rejected(tmp_path):
    save_checkpoint(str(tmp_path), 1, {"a": torch.arange(4)})
    with pytest.raises(AssertionError, match="ckpt"):
        restore_checkpoint(str(tmp_path), 1, {"a": torch.arange(8)})


@pytest.mark.parametrize("template", ["numpy", "tensor", "float64"])
def test_elastic_restore_follows_the_template(tmp_path, template):
    """Arrays are saved with their global shape from wherever they were
    and restored as the template asks: numpy on the host, tensors on
    the template's device (the CPU here; the card in
    tests/test_torch_cuda.py), converted to the template's dtype."""
    state = {"w": torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16),
             "scale": torch.tensor(0.5)}
    save_checkpoint(str(tmp_path), 11, state)
    if template == "numpy":
        tmpl = {"w": np.zeros((8, 16), np.float32),
                "scale": np.zeros((), np.float32)}
    else:
        dt = torch.float32 if template == "tensor" else torch.float64
        tmpl = {"w": torch.zeros((8, 16), dtype=dt),
                "scale": torch.zeros((), dtype=dt)}
    back, man = restore_checkpoint(str(tmp_path), 11, tmpl)
    assert man["shapes"] == {"w": [8, 16], "scale": []}
    for k in state:
        assert type(back[k]) is type(tmpl[k])
        assert back[k].dtype == tmpl[k].dtype
        np.testing.assert_array_equal(np.asarray(back[k], np.float64),
                                      state[k].double().numpy())


def test_async_checkpointer_copies_before_submit_returns(tmp_path):
    """The optimizer updates tensors in place, so ``submit`` must copy:
    a write of step 1 holds step 1's values even when the tensor changes
    right after; ``keep`` old steps stay."""
    ck = AsyncCheckpointer(str(tmp_path), keep=2)
    w = torch.zeros(1000)
    for step in range(1, 5):
        w.fill_(step)
        ck.submit(step, {"w": w})
        w.fill_(-1.0)
    ck.close()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]
    for step in (3, 4):
        back, _ = restore_checkpoint(str(tmp_path), step, {"w": w})
        assert torch.equal(back["w"], torch.full((1000,), float(step)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int32])
def test_host_copies_never_alias(dtype):
    """``to_host`` and ``from_host`` each make one copy, so neither side
    sees a later in-place change of the other; bf16 goes through its
    bits (``V2``); a read-only array (as ``np.asarray`` gives for a JAX
    array) and a 0-d leaf convert too."""
    t = torch.arange(12, dtype=torch.float32).reshape(3, 4).to(dtype)
    a = host.to_host(t)
    assert a.dtype == host.host_dtype(dtype)
    assert (a.dtype == np.dtype("V2")) == (dtype == torch.bfloat16)
    assert host.is_bf16_bits(a) == (dtype == torch.bfloat16)
    want = as_bits(t).copy()
    t.fill_(7)
    np.testing.assert_array_equal(as_bits(a), want)
    back = host.from_host(a, dtype, "cpu")
    np.testing.assert_array_equal(as_bits(back), want)
    back.fill_(5)
    np.testing.assert_array_equal(as_bits(a), want)
    a.setflags(write=False)
    assert torch.equal(host.from_host(a, dtype, "cpu"),
                       host.host_tensor(a))
    s = host.to_host(torch.tensor(3, dtype=torch.int32))
    assert s.shape == () and int(host.from_host(s, torch.int32, "cpu")) == 3


@pytest.mark.parametrize("master", [False, True])
def test_shapes_only_template_restores_as_the_full_one(tmp_path, master):
    """``train_state_to_jax_tree(shapes_only=True)`` gives the train
    state's tree as ``meta`` tensors (no host copy): the keys, shapes and
    dtypes of the numpy tree, and a restore through it loads the state
    bitwise as a restore through the numpy tree does."""
    model, opt = port_state(master=master)
    saved = convert.train_state_to_jax_tree(model, opt)
    meta = convert.train_state_to_jax_tree(model, opt, shapes_only=True)
    full_l, meta_l = dict(tree_leaves(saved)), dict(tree_leaves(meta))
    assert sorted(full_l) == sorted(meta_l)
    for k, a in full_l.items():
        assert meta_l[k].is_meta and tuple(meta_l[k].shape) == a.shape, k
        assert host.host_dtype(meta_l[k].dtype) == a.dtype, k
    save_checkpoint(str(tmp_path), 4, saved)
    back, _ = restore_checkpoint(str(tmp_path), 4, meta)
    assert all(isinstance(a, np.ndarray) for _, a in tree_leaves(back))
    assert_trees_bitwise(back, saved)
    other, other_opt = port_state(master=master, seed=3)
    convert.load_jax_tree(other, back["params"])
    other_opt = convert.opt_state_from_jax(back["opt"], other)
    assert_trees_bitwise(convert.train_state_to_jax_tree(other, other_opt),
                         saved)


# ---- a train state across packages ---------------------------------------------

ARCH = "deepseek-moe-16b"


def jax_two_steps(master: bool = False):
    """JAX's state after one train step (batch 0) and the next step's
    loss (batch 1)."""
    cfg = jax_smoke(ARCH)
    params, opt = jsteps.init_train_state(jax.random.PRNGKey(2), cfg,
                                          master_weights=master)
    step = jax.jit(jsteps.make_train_step(
        cfg, JOptConfig(lr=3e-3, master_weights=master)))
    data = SyntheticDataset(2, 2, 32, cfg.vocab_size)
    params, opt, _ = step(params, opt, jax.tree.map(jnp.asarray,
                                                    data.batch(0)))
    state = {"params": params, "opt": opt}
    _, _, m = step(params, opt, jax.tree.map(jnp.asarray, data.batch(1)))
    return state, float(m["loss"]), data


def port_state(master: bool = False, seed: int = 9):
    cfg = tconfigs.get_smoke_config(ARCH)
    return tsteps.init_train_state(cfg, generator=torch.Generator()
                                   .manual_seed(seed), device="cpu",
                                   master_weights=master)


def torch_batch(data, step):
    return {k: torch.from_numpy(v) for k, v in data.batch(step).items()}


def test_jax_written_train_state_restores_in_port(tmp_path):
    """JAX's float32 state after one step, saved by JAX's
    ``save_checkpoint``, restored into a port state of other values:
    bitwise JAX's arrays, ``step`` 1, and the next step's loss within
    2e-3 relative of JAX's (bf16 products; measured 1.4e-4)."""
    state, want_loss, data = jax_two_steps()
    jax_save(str(tmp_path), 0, state)
    model, opt = port_state()
    tmpl = convert.train_state_to_jax_tree(model, opt)
    back, _ = restore_checkpoint(str(tmp_path), latest_step(str(tmp_path)),
                                 tmpl)
    assert_trees_bitwise(back, jax.tree.map(np.asarray, state))
    convert.load_jax_tree(model, back["params"])
    opt = convert.opt_state_from_jax(back["opt"], model)
    assert int(opt["step"]) == 1 and opt["step"].dtype == torch.int32
    assert_trees_bitwise(convert.train_state_to_jax_tree(model, opt),
                         jax.tree.map(np.asarray, state))
    step = tsteps.make_train_step(tconfigs.get_smoke_config(ARCH),
                                  OptConfig(lr=3e-3))
    _, _, m = step(model, opt, torch_batch(data, 1))
    assert abs(float(m["loss"]) - want_loss) <= 2e-3 * want_loss


def test_port_written_train_state_restores_in_jax(tmp_path):
    """The port's state after one step, saved by the port, restored by
    JAX's ``restore_checkpoint`` into JAX's own template: bitwise the
    port's arrays; JAX's next step from it gives the port's next loss
    within 2e-3 relative."""
    cfg = tconfigs.get_smoke_config(ARCH)
    model, opt = port_state()
    step = tsteps.make_train_step(cfg, OptConfig(lr=3e-3))
    data = SyntheticDataset(2, 2, 32, cfg.vocab_size)
    model, opt, _ = step(model, opt, torch_batch(data, 0))
    saved = convert.train_state_to_jax_tree(model, opt)
    save_checkpoint(str(tmp_path), 0, saved, extra={"arch": ARCH})
    _, _, m = step(model, opt, torch_batch(data, 1))
    jcfg = jax_smoke(ARCH)
    jp, jo = jsteps.init_train_state(jax.random.PRNGKey(0), jcfg)
    back, man = jax_restore(str(tmp_path), 0, {"params": jp, "opt": jo})
    assert man["extra"] == {"arch": ARCH}
    assert_trees_bitwise(back, saved)
    jstep = jax.jit(jsteps.make_train_step(jcfg, JOptConfig(lr=3e-3)))
    _, _, jm = jstep(back["params"], back["opt"],
                     jax.tree.map(jnp.asarray, data.batch(1)))
    assert abs(float(jm["loss"]) - float(m["loss"])) <= \
        2e-3 * float(jm["loss"])


def test_hybrid_train_state_round_trips(tmp_path):
    """zamba2's float32 state after one port step: its layer leaves
    stacked ``[G, attn_every, ...]`` and ``shared_attn`` whole, in JAX's
    layout.  Saved by the port, restored bitwise by JAX's
    ``restore_checkpoint`` into JAX's own template, and by the port into
    a ``shapes_only`` template, then loaded into a fresh state bitwise
    the saved one."""
    arch = "zamba2-2.7b"
    cfg = tconfigs.get_smoke_config(arch)
    model, opt = tsteps.init_train_state(
        cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    data = SyntheticDataset(3, 2, 16, cfg.vocab_size)
    model, opt, _ = tsteps.make_train_step(cfg, OptConfig(lr=3e-3))(
        model, opt, torch_batch(data, 0))
    saved = convert.train_state_to_jax_tree(model, opt)
    g, a = cfg.num_layers // cfg.attn_every, cfg.attn_every
    assert saved["params"]["layers"]["mamba"]["w_in"].shape[:2] == (g, a)
    assert saved["opt"]["mu"]["shared_attn"]["attn"]["wq"].shape == \
        tuple(model.shared_attn.attn.wq.shape)
    save_checkpoint(str(tmp_path), 0, saved, extra={"arch": arch})
    jp, jo = jsteps.init_train_state(jax.random.PRNGKey(0), jax_smoke(arch))
    back, _ = jax_restore(str(tmp_path), 0, {"params": jp, "opt": jo})
    assert_trees_bitwise(back, saved)
    other, other_opt = tsteps.init_train_state(
        cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    tmpl = convert.train_state_to_jax_tree(other, other_opt,
                                           shapes_only=True)
    mine, _ = restore_checkpoint(str(tmp_path), 0, tmpl)
    convert.load_jax_tree(other, mine["params"])
    other_opt = convert.opt_state_from_jax(mine["opt"], other)
    assert_trees_bitwise(convert.train_state_to_jax_tree(other, other_opt),
                         saved)


def test_bf16_state_round_trips_in_port_only(tmp_path):
    """The H2 state (bf16 matrices, float32 masters): a port checkpoint
    restores in the port bitwise, and so does one JAX writes; JAX's own
    ``restore_checkpoint`` refuses both, since numpy reads a bf16 leaf
    back as ``V2`` and cannot cast it (ROADMAP.md Queue 3)."""
    model, opt = port_state(master=True)
    assert model.layers[0].attn.wq.dtype == torch.bfloat16
    saved = convert.train_state_to_jax_tree(model, opt)
    save_checkpoint(str(tmp_path / "port"), 3, saved)
    other, other_opt = port_state(master=True, seed=1)
    back, _ = restore_checkpoint(str(tmp_path / "port"), 3,
                                 convert.train_state_to_jax_tree(
                                     other, other_opt))
    assert_trees_bitwise(back, saved)
    convert.load_jax_tree(other, back["params"])
    assert torch.equal(other.layers[0].attn.wq, model.layers[0].attn.wq)

    state, _, _ = jax_two_steps(master=True)
    jax_save(str(tmp_path / "jax"), 1, state)
    back, _ = restore_checkpoint(str(tmp_path / "jax"), 1, saved)
    assert_trees_bitwise(back, jax.tree.map(np.asarray, state))
    for d, step in (("port", 3), ("jax", 1)):
        with pytest.raises(ValueError, match="cast"):
            jax_restore(str(tmp_path / d), step, state)


# ---- the trainer's restart -------------------------------------------------------

def test_trainer_restart_is_bitwise(tmp_path, capsys):
    """``launch.train.main`` on the MoE SMOKE config, 10 steps with a
    checkpoint every 6 (steps 6 and 9).  A run killed after its step-6
    checkpoint (that directory alone) resumed to step 10 writes a step 9
    bitwise the uninterrupted run's, parameters and optimizer state."""
    args = ["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
            "--seq", "16", "--steps", "10", "--ckpt-every", "6",
            "--log-every", "100"]
    full, cut = tmp_path / "full", tmp_path / "cut"
    loss_full = tlaunch.main(args + ["--ckpt-dir", str(full)])
    assert sorted(os.listdir(full)) == ["step_00000006", "step_00000009"]
    shutil.copytree(full / "step_00000006", cut / "step_00000006")
    capsys.readouterr()
    loss_resumed = tlaunch.main(args + ["--ckpt-dir", str(cut)])
    assert "[restore] resumed from step 6" in capsys.readouterr().out
    assert loss_resumed == loss_full and np.isfinite(loss_full)
    with np.load(full / "step_00000009" / "shard_0.npz") as a, \
            np.load(cut / "step_00000009" / "shard_0.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert any(k.startswith("opt/mu/") for k in a.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert int(a["opt/step"]) == 10
    # resumed past the end: nothing to do
    assert np.isnan(tlaunch.main(args + ["--ckpt-dir", str(cut)]))
