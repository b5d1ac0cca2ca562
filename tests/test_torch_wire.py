"""Port parity of the wire codecs (``repro_torch.core.wire``) against the
JAX package's ``repro.core.wire``: the single-device cases of
tests/test_wire.py (registry, config-time refusals, encode / decode
round trips, byte accountants), each run through both packages on the
same numpy arrays and held bitwise; plus random slabs through every
codec, operator and narrowing."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import graph as JG
from repro.core import operators as jops
from repro.core import wire as jw
from repro.core.balancer import BalancerConfig as JCfg
from repro_torch.core import operators as tops
from repro_torch.core import wire as tw
from repro_torch.core.balancer import BalancerConfig as TCfg

INF = int(JG.INF)
OPS = ("SSSP_RELAX", "BFS_HOP", "CC_MIN", "KCORE_DEC", "PR_PULL")


def _word(x):
    """A JAX wire array as numpy (its own dtype)."""
    return np.asarray(x)


def _codecs(spec, opname=None, dtype=None):
    jop = getattr(jops, opname) if opname else None
    top = getattr(tops, opname) if opname else None
    jdt = None if dtype is None else jnp.dtype(dtype)
    tdt = None if dtype is None else getattr(torch, dtype)
    return (jw.get_codec(spec, jop, jdt), tw.get_codec(spec, top, tdt),
            jop, top)


# ---------------- registry + config-time validation ------------------------

def test_constants_match():
    assert tw.INDEX_BYTES == jw.INDEX_BYTES
    assert tw.BLOCK == jw.BLOCK
    assert tw.WIRE_NAMES == jw.WIRE_NAMES
    assert tw.NARROW_DTYPES == jw.NARROW_DTYPES
    for name in sorted(tw.NARROW_DTYPES):
        jd, jsz, jsent = jw._narrow_info(name)
        _, tsz, tsent = tw._narrow_info(name)
        assert (tsz, tsent) == (jsz, jsent)
    for op in OPS:
        assert getattr(tops, op).wire_narrow == getattr(jops, op).wire_narrow


def test_registry_names_resolve():
    for name in ("identity", "delta", "bitmap"):
        assert tw.get_codec(name).name == name
    q = tw.get_codec("quantize", tops.BFS_HOP)
    assert q.name == "quantize"
    assert q.narrow == tops.BFS_HOP.wire_narrow[0] == "uint16"
    assert tw.get_codec("quantize:int8", tops.BFS_HOP).narrow == "int8"
    assert tw.get_codec("quantize").narrow is None
    assert tw.get_codec("quantize:int16") is tw.get_codec("quantize:int16")


@pytest.mark.parametrize("spec", ["zstd", "quantize:int64", "delta:int8",
                                  "bitmap:uint16"])
def test_unknown_wire_spec_raises_as_jax(spec):
    with pytest.raises(ValueError) as je:
        jw.get_codec(spec)
    with pytest.raises(ValueError) as te:
        tw.get_codec(spec)
    assert str(te.value) == str(je.value)


def test_balancer_config_validates_wire():
    for name in ("identity", "delta", "bitmap", "quantize",
                 "quantize:uint16"):
        assert TCfg(wire=name).wire == name == JCfg(wire=name).wire
    with pytest.raises(ValueError, match="unknown wire codec"):
        TCfg(wire="bogus")


def test_balancer_imports_validate_wire_from_wire():
    """One validator, in core/wire.py, as the JAX package has it."""
    from repro_torch.core import balancer as tb
    assert tb.validate_wire is tw.validate_wire
    assert not hasattr(tb, "_WIRE_NAMES")


@pytest.mark.parametrize("spec,opname,dtype", [
    ("quantize", "SSSP_RELAX", None), ("quantize", "CC_MIN", None),
    ("quantize:int8", "KCORE_DEC", None), ("quantize:uint8", "BFS_HOP",
                                           None),
    ("quantize", "PR_PULL", "float32"), ("quantize", "BFS_HOP", "float32"),
    ("quantize:uint16", "KCORE_DEC", "float32")])
def test_quantize_refusals_match_jax(spec, opname, dtype):
    """The config-time refusals, with JAX's messages: an operator that
    declares no narrowing, one outside the declared set, a float
    payload."""
    jop, top = getattr(jops, opname), getattr(tops, opname)
    jdt = jnp.dtype(dtype) if dtype else None
    tdt = getattr(torch, dtype) if dtype else None
    with pytest.raises(ValueError) as je:
        jw.get_codec(spec, jop, jdt)
    with pytest.raises(ValueError) as te:
        tw.get_codec(spec, top, tdt)
    assert str(te.value) == str(je.value)


def test_quantize_float_refused_by_validate():
    with pytest.raises(ValueError, match="integer payloads"):
        tw.WireCodec("quantize", narrow="uint16").validate(
            tops.BFS_HOP, torch.float32)


# ---------------- encode / decode ------------------------------------------

def _both_round_trip(spec, opname, payload, prev, signed=True):
    jc, tc, jop, top = _codecs(spec, opname)
    jenc = jc.encode(jnp.asarray(payload), jnp.asarray(prev), jop)
    tenc = tc.encode(torch.from_numpy(payload), torch.from_numpy(prev), top)
    np.testing.assert_array_equal(tw.word_numpy(tenc, tc), _word(jenc))
    assert tw.word_numpy(tenc, tc).dtype == _word(jenc).dtype
    jdec = jc.decode(jenc, jnp.asarray(prev), jop, jnp.int32, signed=signed)
    tdec = tc.decode(tenc, torch.from_numpy(prev), top, torch.int32,
                     signed=signed)
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))
    assert tdec.dtype == torch.int32
    return tdec.numpy()


def test_delta_int_round_trip_exact():
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 1 << 30, (3, 64)).astype(np.int32)
    prev = rng.integers(0, 1 << 30, (3, 64)).astype(np.int32)
    payload[0, 0] = (1 << 31) - 1           # the neutral: wraps and back
    prev[1, 1] = -(1 << 31)
    dec = _both_round_trip("delta", "SSSP_RELAX", payload, prev)
    np.testing.assert_array_equal(dec, payload)


def test_delta_float_ships_raw():
    payload = torch.tensor([[0.1, 0.7]])
    prev = torch.tensor([[0.05, 0.7]])
    enc = tw.DELTA.encode(payload, prev, tops.PR_PULL)
    assert torch.equal(enc, payload)
    assert torch.equal(tw.DELTA.decode(enc, prev, tops.PR_PULL,
                                       torch.float32), payload)


def test_quantize_min_round_trip_with_sentinel():
    hops = np.asarray([[0, 7, 65534, INF, (1 << 31) - 1]], np.int32)
    dec = _both_round_trip("quantize", "BFS_HOP", hops, np.zeros_like(hops))
    np.testing.assert_array_equal(dec[0], [0, 7, 65534, INF, INF])


def test_quantize_add_round_trip_sign_extends():
    deltas = np.asarray([[0, -1, -37, -32768 + 1, 255]], np.int32)
    dec = _both_round_trip("quantize", "KCORE_DEC", deltas,
                           np.zeros_like(deltas))
    np.testing.assert_array_equal(dec, deltas)


def test_quantize_add_broadcast_labels_zero_extend():
    labels = np.asarray([[0, 7, 32768, 40000, 65535]], np.int32)
    dec = _both_round_trip("quantize", "KCORE_DEC", labels,
                           np.zeros_like(labels), signed=False)
    np.testing.assert_array_equal(dec, labels)
    signed = _both_round_trip("quantize", "KCORE_DEC", labels,
                              np.zeros_like(labels))
    assert signed[0, 2] < 0


def test_quantize_int8_round_trip():
    hops = np.asarray([[0, 3, 126, INF]], np.int32)
    dec = _both_round_trip("quantize:int8", "BFS_HOP", hops,
                           np.zeros_like(hops))
    np.testing.assert_array_equal(dec[0], [0, 3, 126, INF])


@pytest.mark.parametrize("narrow", ["int8", "uint8", "int16", "uint16"])
@pytest.mark.parametrize("opname", ["BFS_HOP", "KCORE_DEC"])
@pytest.mark.parametrize("signed", [True, False])
def test_quantize_every_narrowing_matches_jax(narrow, opname, signed):
    """Every narrow dtype, for a min and an add operator, on values that
    wrap, saturate and hit each sentinel: words and both widenings
    bitwise JAX's (the codec is built directly, as the narrowing need
    not be declared for the transform)."""
    rng = np.random.default_rng(7)
    vals = np.concatenate([
        rng.integers(-(1 << 31), (1 << 31) - 1, 40),
        rng.integers(-300, 300, 40),
        [0, -1, 127, 128, 255, 256, 32767, 32768, 65535, 65536, INF,
         (1 << 31) - 1, -(1 << 31)]]).astype(np.int32).reshape(3, -1)
    jc, tc = jw.WireCodec("quantize", narrow), tw.WireCodec("quantize",
                                                            narrow)
    jop, top = getattr(jops, opname), getattr(tops, opname)
    prev = np.zeros_like(vals)
    jenc = jc.encode(jnp.asarray(vals), jnp.asarray(prev), jop)
    tenc = tc.encode(torch.from_numpy(vals), torch.from_numpy(prev), top)
    np.testing.assert_array_equal(tw.word_numpy(tenc, tc), np.asarray(jenc))
    jdec = jc.decode(jenc, jnp.asarray(prev), jop, jnp.int32, signed=signed)
    tdec = tc.decode(tenc, torch.from_numpy(prev), top, torch.int32,
                     signed=signed)
    np.testing.assert_array_equal(tdec.numpy(), np.asarray(jdec))


# ---------------- byte accountants -----------------------------------------

def _slab(b=2, n=32, n_live=10, seed=1):
    rng = np.random.default_rng(seed)
    payload = rng.integers(0, 1000, (b, n)).astype(np.int32)
    live = np.arange(n) < n_live
    return payload, live


def _step_bytes(codec_spec, opname, payload, prev, live):
    jc, tc, jop, top = _codecs(codec_spec, opname)
    j = int(jc.step_wire_bytes(jnp.asarray(payload), jnp.asarray(prev),
                               jnp.asarray(live), jop))
    t = tc.step_wire_bytes(torch.from_numpy(payload), torch.from_numpy(prev),
                           torch.from_numpy(live), top)
    assert t.dtype == torch.int32 and t.ndim == 0
    assert int(t) == j
    return j


def test_step_logical_bytes_counts_index_word():
    _, live = _slab()
    got = tw.step_logical_bytes(torch.from_numpy(live), 2, 4)
    assert int(got) == int(jw.step_logical_bytes(jnp.asarray(live), 2, 4))
    assert int(got) == 10 * (tw.INDEX_BYTES + 2 * 4)


def test_identity_wire_equals_logical():
    payload, live = _slab()
    assert _step_bytes("identity", "SSSP_RELAX", payload, payload,
                       live) == 10 * (4 + 2 * 4)


def test_quantize_wire_bytes_scale_by_narrow_itemsize():
    payload, live = _slab()
    assert _step_bytes("quantize", "BFS_HOP", payload, payload,
                       live) == 10 * (4 + 2 * 2)


def test_bitmap_wire_bytes_hybrid():
    payload, live = _slab(n=64, n_live=40)
    assert _step_bytes("bitmap", "SSSP_RELAX", payload, payload,
                       live) == 8 + 40 * 2 * 4
    payload, live = _slab(n=64, n_live=1)
    assert _step_bytes("bitmap", "SSSP_RELAX", payload, payload,
                       live) == 4 + 2 * 4
    payload, live = _slab(n=64, n_live=0)
    assert _step_bytes("bitmap", "SSSP_RELAX", payload, payload, live) == 0


def test_delta_wire_bytes_suppress_unchanged():
    payload, live = _slab(b=4, n=32, n_live=16)
    assert _step_bytes("delta", "SSSP_RELAX", payload, payload,
                       live) == 16 * 4 + 16 * 1
    rng = np.random.default_rng(7)
    payload = rng.integers(1000, 1200, (4, 32)).astype(np.int32)
    assert _step_bytes("delta", "SSSP_RELAX", payload, payload - 3,
                       live) == 16 * 4 + 16 + 4 * 4 + 16 * 4


def test_delta_wire_bytes_float_mask_path():
    rng = np.random.default_rng(2)
    payload = rng.random((1, 16)).astype(np.float32)
    live = np.arange(16) < 8
    prev = payload.copy()
    prev[0, :4] += 1.0
    assert _step_bytes("delta", "PR_PULL", payload, prev,
                       live) == 8 * 4 + 8 * 1 + 4 * 4


@pytest.mark.parametrize("b", [1, 3, 8])
@pytest.mark.parametrize("spec", ["identity", "delta", "bitmap",
                                  "quantize"])
def test_step_wire_bytes_random_slabs(spec, b):
    """Random slabs with wide spreads (1-, 2- and 4-byte offsets), the
    neutral, sparse and dense live sets: bytes equal JAX's."""
    rng = np.random.default_rng(b)
    for n, n_live in ((7, 0), (64, 1), (64, 40), (300, 300)):
        payload = rng.choice([0, 5, 300, 70000, INF, (1 << 31) - 1],
                             (b, n)).astype(np.int32)
        payload += rng.integers(0, 3, (b, n)).astype(np.int32)
        prev = np.where(rng.random((b, n)) < 0.5, payload,
                        payload - 1).astype(np.int32)
        live = rng.permutation(np.arange(n) < n_live)
        _step_bytes(spec, "BFS_HOP", payload, prev, live)


def test_allreduce_wire_bytes():
    new = np.arange(64, dtype=np.int32).reshape(1, 64)
    prev = new.copy()
    prev[0, :16] += 1
    for spec, want in (("identity", 64 * 4), ("bitmap", 64 * 4),
                       ("delta", 8 + 16 * 4), ("quantize", 64 * 2)):
        jc, tc, _, _ = _codecs(spec, "BFS_HOP")
        j = int(jc.allreduce_wire_bytes(jnp.asarray(new),
                                        jnp.asarray(prev)))
        t = tc.allreduce_wire_bytes(torch.from_numpy(new),
                                    torch.from_numpy(prev))
        assert t.dtype == torch.int32 and int(t) == j == want


def test_allreduce_wire_bytes_float():
    rng = np.random.default_rng(5)
    new = rng.random((2, 100)).astype(np.float32)
    prev = np.where(rng.random((2, 100)) < 0.3, new, 0).astype(np.float32)
    for spec in ("identity", "delta", "bitmap"):
        jc, tc, _, _ = _codecs(spec)
        assert int(tc.allreduce_wire_bytes(torch.from_numpy(new),
                                           torch.from_numpy(prev))) == int(
            jc.allreduce_wire_bytes(jnp.asarray(new), jnp.asarray(prev)))


def test_shared_block_helpers_round_trip():
    x = np.random.default_rng(3).random(300).astype(np.float32)
    jb, jpad = jw.pad_to_block(jnp.asarray(x))
    tb, tpad = tw.pad_to_block(torch.from_numpy(x))
    assert tb.shape == (2, tw.BLOCK) and tpad == jpad == 2 * tw.BLOCK - 300
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    js = jw.block_absmax_scale(jb)
    ts = tw.block_absmax_scale(tb)
    assert ts.shape == (2, 1)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert float((tb / ts).abs().max()) <= 127.0 + 1e-6
