"""Port parity of the LM-stack kernels: ``positions_in_expert`` and
``flash_attention`` of ``repro_torch`` (their plain versions, which the
wrappers run on CPU tensors) against the JAX package's Pallas kernels
in interpret mode and its ``ref.py`` oracles, on the same numpy inputs.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.moe_dispatch import positions_in_expert_kernel
from repro.models import moe as jmoe
from repro_torch import kernels as tk
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import moe_dispatch as tmd
from repro_torch.kernels import ref as tref
from repro_torch.models import moe as tmoe


# ---- positions_in_expert ----------------------------------------------------

@pytest.mark.parametrize("n,e", [(64, 8), (1000, 64), (4096, 16), (1, 1),
                                 (2049, 64), (24, 64)])
def test_positions_in_expert_matches_jax(n, e):
    """Exact against the Pallas kernel (interpret mode), the JAX oracle
    and ``moe._positions_in_expert``, and against the port's plain
    versions, on uniform and one-expert streams."""
    rng = np.random.default_rng(n * 131 + e)
    for ids in (rng.integers(0, e, n), np.full(n, e - 1)):
        ids = ids.astype(np.int32)
        want = np.asarray(positions_in_expert_kernel(jnp.asarray(ids), e,
                                                     tile=256))
        np.testing.assert_array_equal(
            want, np.asarray(jref.positions_in_expert_ref(jnp.asarray(ids),
                                                          e)))
        np.testing.assert_array_equal(
            want, np.asarray(jmoe._positions_in_expert(jnp.asarray(ids), e)))
        t = torch.from_numpy(ids)
        for got in (tmd.positions_in_expert(t, e),
                    tref.positions_in_expert_ref(t, e),
                    tmoe._positions_in_expert(t, e)):
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want)


def test_positions_in_expert_out_of_range_ids_match_the_tpu_kernel():
    """Ids outside [0, E) (the TPU wrapper's padding is E + 1) get 0 and
    count for nothing, as in the Pallas kernel.  (The JAX one-hot oracle
    fills INT32_MIN for ids >= E: ROADMAP Queue 3.)"""
    rng = np.random.default_rng(7)
    ids = rng.integers(-3, 11, 700).astype(np.int32)
    want = np.asarray(positions_in_expert_kernel(jnp.asarray(ids), 8,
                                                 tile=128))
    got = tmd.positions_in_expert(torch.from_numpy(ids), 8).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[(ids < 0) | (ids >= 8)] == 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_positions_in_expert_property(seed):
    """Within each expert, positions are 0..count-1 in arrival order."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, 8, rng.integers(1, 3000)).astype(np.int32)
    pos = tmd.positions_in_expert(torch.from_numpy(ids), 8).numpy()
    for e in range(8):
        np.testing.assert_array_equal(pos[ids == e],
                                      np.arange((ids == e).sum()))


def test_positions_in_expert_empty_and_validation():
    empty = torch.zeros(0, dtype=torch.int32)
    assert tmd.positions_in_expert(empty, 8).shape == (0,)
    with pytest.raises(ValueError, match="num_experts"):
        tmd.positions_in_expert(empty, tmd.MAX_EXPERTS + 1)
    with pytest.raises(TypeError, match="flat_expert"):
        tmd.positions_in_expert(empty.long(), 8)
    with pytest.raises(ValueError, match="1-D"):
        tmd.positions_in_expert(torch.zeros((2, 3), dtype=torch.int32), 8)


# ---- flash_attention --------------------------------------------------------

def _qkv(seed, b, s, h, hkv, hd, dtype):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, n, hd)).astype(np.float32)
            for n in (h, hkv, hkv)]


@pytest.mark.parametrize("s,causal", [(128, True), (256, True),
                                      (128, False)])
@pytest.mark.parametrize("h,hkv", [(4, 2), (8, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_matches_jax(s, h, hkv, dtype, causal):
    """The port's flash_attention (plain on CPU) against the Pallas
    kernel (interpret mode) and ``ref.flash_attention_ref``.  Tolerance
    as tests/test_kernels_lm.py: float32 2e-5 (measured at most 8.4e-7),
    bf16 2e-2 (outputs differ by a bf16 rounding: measured at most
    2.0e-3)."""
    b, hd = 2, 64
    arrs = _qkv(s + h + causal, b, s, h, hkv, hd, dtype)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jd) for a in arrs)
    tq, tk_, tv = (torch.from_numpy(a).to(td) for a in arrs)
    got = tfa.flash_attention(tq, tk_, tv, causal=causal)
    assert got.dtype == td and got.shape == (b, s, h, hd)
    got = got.float().numpy()
    tol = 2e-2 if dtype == "bfloat16" else 2e-5
    for want in (jflash(jq, jk, jv, causal=causal),
                 jref.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=tol, atol=tol)


@pytest.mark.parametrize("hd,h,hkv", [(80, 4, 4), (256, 4, 1)])
def test_flash_attention_wide_heads_match_jax(hd, h, hkv):
    """The head widths of zamba2's shared block (80) and paligemma (256,
    GQA 8:1 there), which the simt kernel takes: the plain version
    against the Pallas kernel (interpret mode), bf16, causal, at the
    tolerance of ``test_flash_attention_matches_jax``."""
    arrs = _qkv(hd, 1, 128, h, hkv, hd, "bfloat16")
    got = tfa.flash_attention(*(torch.from_numpy(a).bfloat16()
                                for a in arrs))
    want = jflash(*(jnp.asarray(a, jnp.bfloat16) for a in arrs),
                  causal=True)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("s", [1, 37, 100])
def test_flash_attention_ragged_lengths_match_the_jax_oracle(s):
    """Any S (the CUDA kernel masks the ragged edge; the TPU kernel
    needs S % 128 == 0): the plain version against the JAX oracle,
    float32, head width 16 as the SMOKE configs have."""
    arrs = _qkv(s, 2, s, 4, 2, 16, "float32")
    got = tfa.flash_attention(*(torch.from_numpy(a) for a in arrs))
    want = jref.flash_attention_ref(*(jnp.asarray(a) for a in arrs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_flash_attention_validation():
    q = torch.zeros((1, 8, 4, 16))
    with pytest.raises(ValueError, match="Sq == Skv"):
        tfa.flash_attention(q, torch.zeros((1, 9, 2, 16)),
                            torch.zeros((1, 9, 2, 16)))
    with pytest.raises(ValueError, match="multiple"):
        tfa.flash_attention(q, torch.zeros((1, 8, 3, 16)),
                            torch.zeros((1, 8, 3, 16)))
    with pytest.raises(ValueError, match="head dim"):
        big = torch.zeros((1, 8, 2, tfa.MAX_HEAD_DIM + 1))
        tfa.flash_attention(big, big, big)
    with pytest.raises(TypeError, match="dtype"):
        tfa.flash_attention(q, q.bfloat16(), q)
    with pytest.raises(ValueError, match="contiguous"):
        t = torch.zeros((1, 4, 8, 16)).transpose(1, 2)
        tfa.flash_attention(t, t, t)


@pytest.mark.parametrize("dtype,hd,want", [
    (torch.bfloat16, 128, "wgmma"), (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 96, "simt"),
    (torch.bfloat16, 32, "simt"), (torch.float32, 128, "simt"),
    (torch.float32, 64, "simt"), (torch.bfloat16, 80, "wgmma"),
    (torch.bfloat16, 256, "wgmma"), (torch.float32, 80, "simt"),
    (torch.float32, 256, "simt")])
def test_flash_attention_route(dtype, hd, want):
    """bf16 at head width 64, 80, 128 or 256 goes to the wgmma kernel;
    float32 (whose tolerance a TF32 product would break) and other
    widths to the CUDA-core kernel."""
    assert tfa.route(dtype, hd) == want


def test_flash_attention_tma_alignment_check():
    """The wgmma route refuses a tensor whose first element is not
    16-byte aligned: a contiguous view at an odd storage offset."""
    base = torch.zeros(8 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:8 * 64].view(1, 2, 4, 64)
    shifted = base[1:1 + 8 * 64].view(1, 2, 4, 64)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 2
    tfa.check_tma(q=aligned, k=aligned)
    with pytest.raises(ValueError, match="k starts at .* not 16-byte"):
        tfa.check_tma(q=aligned, k=shifted)
    # on the CPU the plain version takes it as it is
    got = tfa.flash_attention(shifted, shifted, shifted)
    want = tref.flash_attention_ref(shifted.clone(), shifted.clone(),
                                    shifted.clone())
    assert torch.equal(got, want)


def test_lm_kernels_count_no_launch_on_cpu():
    tk.reset_launch_counts()
    tmd.positions_in_expert(torch.zeros(5, dtype=torch.int32), 4)
    x = torch.zeros((1, 3, 2, 16))
    tfa.flash_attention(x, x, x)
    tfa.flash_attention(*(torch.zeros((1, 3, 2, 128),
                                      dtype=torch.bfloat16),) * 3)
    assert tk.launch_counts()["positions_in_expert"] == 0
    assert tk.launch_counts()["flash_attention"] == 0
    assert tfa.flash_attention.launches_by_route == {"wgmma": 0, "simt": 0}
    assert tk.KERNELS["flash_attention"] is tfa.flash_attention
    assert tk.KERNELS["positions_in_expert"] is tmd.positions_in_expert


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("hd,h,hkv", [(80, 4, 4), (256, 8, 1)])
def test_flash_attention_wide_heads_launch_nothing_on_cpu(dtype, hd, h,
                                                          hkv):
    """CPU tensors at zamba2's and paligemma's head widths take the
    plain version, whichever route the card would give them: neither
    route counts a launch."""
    tk.reset_launch_counts()
    q, k = (torch.zeros((1, 5, n, hd), dtype=dtype) for n in (h, hkv))
    got = tfa.flash_attention(q, k, k)
    assert got.shape == q.shape and got.dtype == dtype
    assert tfa.flash_attention.launches_by_route == {"wgmma": 0, "simt": 0}
    assert tfa.flash_attention.launches == 0
