"""Port parity of the Mamba2 / SSD block (``repro_torch.models.mamba2``)
against ``repro.models.mamba2`` on the same numpy inputs.

Tolerances: the SSD math is float32 in both packages, with the
three-operand einsums contracted in XLA's order, so ``ssd_chunked`` and
``ssd_step`` hold at 2e-5 of the largest magnitude (summation order
inside a product differs: measured at most 1.2e-6).  ``_causal_conv``
and ``mamba2_apply`` run in bf16 as JAX does; torch and XLA round the
bf16 products and SiLU apart by an ulp, so those hold within 1/32 of the
largest magnitude, a few bf16 ulps (measured at most 4.4e-3 for the
convolution and 8.5e-3 for the block).  Bitwise: the state shapes and
dtypes and the conv state ``_causal_conv`` returns.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke
from repro.models import mamba2 as jm
from repro_torch.configs import get_smoke_config
from repro_torch.models import convert
from repro_torch.models import mamba2 as tm

SSD_TOL = 2e-5


def rnd(seed, shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def close(got, want, rtol):
    want = np.asarray(want, np.float32)
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rtol * max(np.abs(want).max(), 1e-30))


def ssd_inputs(seed, b, s, h, p, n):
    x, dt = rnd(seed, (b, s, h, p)), rnd(seed + 1, (b, s, h))
    bb, cc = rnd(seed + 2, (b, s, n)), rnd(seed + 3, (b, s, n))
    a_log = np.log(np.linspace(1.0, 16.0, h)).astype(np.float32)
    return x, dt, a_log, bb, cc


@pytest.mark.parametrize("s,chunk", [(32, 8), (37, 8), (5, 16), (64, 64)])
def test_ssd_chunked_matches_jax(s, chunk):
    """float32; S a multiple of ``chunk``, not one (37, 5: the padded
    steps are the identity), and one chunk."""
    arrs = ssd_inputs(s, 2, s, 3, 4, 6)
    jy, jh = jm.ssd_chunked(*(jnp.asarray(a) for a in arrs), chunk=chunk)
    ty, th = tm.ssd_chunked(*(torch.from_numpy(a) for a in arrs),
                            chunk=chunk)
    assert ty.shape == (2, s, 3, 4) and th.shape == (2, 3, 4, 6)
    assert th.dtype == torch.float32
    close(ty, jy, SSD_TOL)
    close(th, jh, SSD_TOL)


def test_ssd_step_chained_matches_ssd_chunked():
    """Seven ``ssd_step`` calls from the state ``ssd_chunked`` left after
    13 positions equal ``ssd_chunked`` over all 20 (the port's two
    functions, and JAX's ``ssd_step`` from the same state)."""
    x, dt, a_log, bb, cc = ssd_inputs(7, 2, 20, 3, 4, 6)
    t = [torch.from_numpy(a) for a in (x, dt, a_log, bb, cc)]
    y_all, h_all = tm.ssd_chunked(*t, chunk=8)
    _, h = tm.ssd_chunked(t[0][:, :13], t[1][:, :13], t[2], t[3][:, :13],
                          t[4][:, :13], chunk=8)
    jh = jnp.asarray(h.numpy())
    for i in range(13, 20):
        y, h = tm.ssd_step(h, t[0][:, i], t[1][:, i], t[2], t[3][:, i],
                           t[4][:, i])
        jy, jh = jm.ssd_step(jh, *(jnp.asarray(a[:, i]) for a in
                                   (x, dt)), jnp.asarray(a_log),
                             jnp.asarray(bb[:, i]), jnp.asarray(cc[:, i]))
        close(y, y_all[:, i].numpy(), SSD_TOL)
        close(y, jy, SSD_TOL)
    close(h, h_all.numpy(), SSD_TOL)
    close(h, jh, SSD_TOL)


def test_softplus_is_jax_softplus_above_twenty():
    """``logaddexp(x, 0)``: torch's ``F.softplus`` returns x itself above
    its threshold 20; JAX's does not switch (float32, 1e-6)."""
    x = np.array([-1e4, -30.0, -1.0, 0.0, 1.0, 19.9, 20.1, 25.0, 80.0],
                 np.float32)
    np.testing.assert_allclose(tm.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    assert float(tm.softplus(torch.tensor(-1e4))) == 0.0


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(with_state):
    """bf16 taps over ``[B, S, C]`` from no state (zeros) or a carried
    ``[B, d_conv - 1, C]`` state; the new state is bitwise the last
    ``d_conv - 1`` inputs."""
    xbc, w = rnd(1, (2, 9, 12)), rnd(2, (4, 12), 0.5)
    bias, st = rnd(3, (12,), 0.1), rnd(4, (2, 3, 12))
    jst = jnp.asarray(st, jnp.bfloat16) if with_state else None
    tst = torch.from_numpy(st).bfloat16() if with_state else None
    jo, jn = jm._causal_conv(jnp.asarray(xbc, jnp.bfloat16),
                             jnp.asarray(w, jnp.bfloat16), jnp.asarray(bias),
                             jst)
    to, tn = tm._causal_conv(torch.from_numpy(xbc).bfloat16(),
                             torch.from_numpy(w).bfloat16(),
                             torch.from_numpy(bias), tst)
    assert to.dtype == tn.dtype == torch.bfloat16
    close(to, jo, 1 / 32)
    np.testing.assert_array_equal(tn.float().numpy(),
                                  np.asarray(jn, np.float32))


def mamba_pair(arch, seed):
    jcfg, tcfg = jax_smoke(arch), get_smoke_config(arch)
    jp = jm.mamba2_init(jax.random.PRNGKey(seed), jcfg)
    tp = convert.load_jax_tree(tm.Mamba2(tcfg, device="cpu"),
                               jax.tree.map(np.asarray, jp))
    return jcfg, tcfg, jp, tp


def test_mamba2_params_keep_jax_dtypes():
    """Matrices bf16 to serve; a_log, dt_bias, d_skip, conv_b and
    out_norm float32 (JAX casts conv_b and d_skip to bf16 at use)."""
    _, _, _, tp = mamba_pair("mamba2-2.7b", 0)
    dtypes = {n: p.dtype for n, p in tp.named_parameters()}
    assert {n for n, d in dtypes.items() if d == torch.bfloat16} == {
        "w_in", "conv_w", "w_out"}
    assert {n for n, d in dtypes.items() if d == torch.float32} == {
        "conv_b", "a_log", "dt_bias", "d_skip", "out_norm"}


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "zamba2-2.7b"])
def test_mamba2_apply_matches_jax(arch):
    """Prefill of 37 positions (chunk 32: one full chunk and a padded
    one) with ``return_state``, then 3 stateful decode steps, against
    ``mamba2_apply``: outputs and the SSD state within 1/32 of their
    magnitude, the conv state (bf16 inputs of the last steps) too."""
    jcfg, tcfg, jp, tp = mamba_pair(arch, 1)
    x = rnd(5, (2, 40, tcfg.d_model))
    jo, js = jm.mamba2_apply(jp, jnp.asarray(x[:, :37], jnp.bfloat16), jcfg,
                             return_state=True)
    to, ts = tm.mamba2_apply(tp, torch.from_numpy(x[:, :37]).bfloat16(),
                             tcfg, return_state=True)
    assert to.dtype == torch.bfloat16 and to.shape == (2, 37, tcfg.d_model)
    assert {n: (tuple(t.shape), t.dtype) for n, t in ts.items()} == {
        n: sd for n, sd in tm.mamba2_state_shape(tcfg, 2).items()}
    close(to, jo, 1 / 32)
    for i in range(37, 40):
        xi = x[:, i:i + 1]
        jo, js = jm.mamba2_apply(jp, jnp.asarray(xi, jnp.bfloat16), jcfg,
                                 state=js)
        to, ts = tm.mamba2_apply(tp, torch.from_numpy(xi).bfloat16(), tcfg,
                                 state=ts)
        close(to, jo, 1 / 32)
    for n in ("h", "conv"):
        close(ts[n], js[n], 1 / 32)
    with pytest.raises(ValueError, match="one token"):
        tm.mamba2_apply(tp, torch.from_numpy(x[:, :2]).bfloat16(), tcfg,
                        state=ts)
