"""The CUDA kernels of ``repro_torch`` against their plain versions on
the card (exact: masks equal, masked positions equal).  Marked ``gpu``:
they skip without a CUDA device.  No JAX import, so the file also runs
on a machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import edge_lb as tlb
from repro_torch.kernels import ref as tref
from repro_torch.kernels import twc_gather as ttwc


def _huge(rng, h):
    deg = rng.integers(1, 300, h).astype(np.int32)
    start_e = (np.cumsum(deg) - deg).astype(np.int32)
    row = rng.integers(0, 1 << 20, h).astype(np.int32)
    val = rng.integers(0, 1 << 10, h).astype(np.int32)
    return deg, start_e, row, val


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("distribution", ["cyclic", "blocked"])
def test_cuda_kernels_match_plain(cuda_device, distribution):
    rng = np.random.default_rng(3)
    deg, start_e, row, val = _huge(rng, 777)
    t = [torch.from_numpy(a).to(cuda_device) for a in (start_e, row, val)]
    total = int(deg.sum())
    k = tlb.edge_lb_map(*t, total, total, distribution=distribution)
    p = tref.edge_lb_map_ref(*t, total, total, distribution=distribution)
    assert torch.equal(k[3], p[3])
    for a, b in zip(k[:3], p[:3]):
        assert torch.equal(a[k[3]], b[p[3]])
    for width in (8, 128, 1024):
        v = [torch.from_numpy(rng.integers(0, 3 * width, 300)
                              .astype(np.int32)).to(cuda_device)
             for _ in range(4)]
        k = ttwc.twc_bin_map(*v, width=width, chunk=1, sentinel=600)
        p = tref.twc_bin_map_ref(*v, width=width, chunk=1, sentinel=600)
        assert torch.equal(k[3], p[3])
        for a, b in zip(k[:3], p[:3]):
            assert torch.equal(a[k[3]], b[p[3]])
