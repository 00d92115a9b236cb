"""The hand-written CUDA kernels against their plain PyTorch versions.

These run only on a machine with an NVIDIA GPU (a CUDA kernel has no
CPU mode) and skip elsewhere.  The file imports neither JAX nor the
conftest's fixtures, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda -q --noconftest

Tolerances: ``binmax_int8`` sums int8 products exactly, so it must match
bit for bit; ``fused_topk_int8`` sums real-valued products in another
order than the plain version, so scores agree within 1e-5 and ids agree
except at near-ties (checked against an f64 rescore).
"""

import numpy as np
import pytest
import torch

from modular_rag_system_tpu_torch.ops import binmax_topk as pb
from modular_rag_system_tpu_torch.ops import fused_topk as pf
from modular_rag_system_tpu_torch.ops.quantize import quantize_rows

D = 768


@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from modular_rag_system_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _rows(seed, cap, count, dev):
    rng = np.random.default_rng(seed)
    E = rng.standard_normal((cap, D)).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    E[count:] = 0
    E_q, sc = quantize_rows(torch.from_numpy(E).to(dev))
    return E_q, sc.reshape(-1)


def _queries(seed, Q, dev):
    q = np.random.default_rng(seed).standard_normal((Q, D)).astype(np.float32)
    return torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,Q", [(8192, 1), (8192, 70), (16384, 256)])
def test_binmax_int8_kernel_bit_exact(cuda_device, cap, Q):
    E_q, sc = _rows(0, cap, cap - 7, cuda_device)
    q_i8, q_scale = pb.quantize_queries(_queries(1, Q, cuda_device))
    args = (E_q, sc, q_i8, q_scale, 32)
    assert torch.equal(pb.binmax_int8_call(*args), pb.binmax_int8_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,count,k,bw", [
    (1024, 1000, 10, None), (4096, 4000, 2048, None), (32768, 32000, 1024, None),
    (1024, 5, 10, None), (4096, 4000, 20, 128)])
def test_fused_topk_int8_kernel_matches_plain(cuda_device, cap, count, k, bw):
    E_q, sc = _rows(2, cap, count, cuda_device)
    q = _queries(3, 16, cuda_device)
    v1, i1 = pf.fused_topk_int8_raw(E_q, sc, count, q, k, bw)
    v2, i2 = pf.fused_topk_int8_reference(E_q, sc, count, q, k, bw)
    fin = torch.isfinite(v2)
    assert torch.equal(torch.isfinite(v1), fin)
    torch.testing.assert_close(v1[fin], v2[fin], rtol=1e-5, atol=1e-5)
    bad = (i1 != i2) & fin
    if bad.any():  # only near-ties may swap
        rows = i1[bad].long()
        qb = q.to(torch.bfloat16).double()[bad.nonzero()[:, 0]]
        exact = (qb * E_q[rows].double()).sum(1) * sc[rows].double()
        assert (exact - v2[bad].double()).abs().max().item() <= 2e-5
