"""The hand-written CUDA kernels against their plain PyTorch versions.

These run only on a machine with an NVIDIA GPU (a CUDA kernel has no
CPU mode) and skip elsewhere.  The file imports neither JAX nor the
conftest's fixtures, so it also runs where JAX is not installed:

    python -m pytest tests/test_torch_kernels.py -m cuda -q --noconftest

Tolerances: ``binmax_int8`` sums int8 products exactly, so it must match
bit for bit, and so must every kernel on integer-valued inputs (all
partial sums exact); on real-valued inputs the kernels sum f32 products
in another order than the plain versions (``binmax`` on the tensor
cores), so scores agree within 1e-5 and ids agree except at near-ties
(checked against an f64 rescore); the -inf pattern is always identical.
``mea_attention`` in bf16 rounds its probabilities and its output to
bf16, so a last-bit difference in f32 can move an output by one bf16
step: |d| <= 2^-7 |ref| + 1e-5 there, 1e-5 in f32; its window mode
holds the same bounds, and a row with no live key in its band is zeros
in both versions.  ``clip_adamw`` rounds every operation as the plain
version does, but sums the squares in another order, so the norm agrees
within 1e-6 relative, and so does every updated value (relative to
itself, with 1e-6 of the buffer's largest as the floor where a first
moment cancels to near 0); two runs of the kernel on the same inputs
agree bit for bit.
"""

import numpy as np
import pytest
import torch

from modular_rag_system_tpu_torch.ops import binmax_topk as pb
from modular_rag_system_tpu_torch.ops import clip_adamw as pca
from modular_rag_system_tpu_torch.ops import flash_attention as pfa
from modular_rag_system_tpu_torch.ops import fused_topk as pf
from modular_rag_system_tpu_torch.ops import ivf2 as pivf
from modular_rag_system_tpu_torch.ops.quantize import quantize_int4_blocks, quantize_rows

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


def _queries(seed, Q, dev, d=D):
    q = np.random.default_rng(seed).standard_normal((Q, d)).astype(np.float32)
    return torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("cap,Q", [(8192, 1), (8192, 70), (16384, 256)])
def test_binmax_int8_kernel_bit_exact(cuda_device, cap, Q):
    E_q, sc = _rows(0, cap, cap - 7, cuda_device)
    q_i8, q_scale = pb.quantize_queries(_queries(1, Q, cuda_device))
    args = (E_q, sc, q_i8, q_scale, 32)
    assert torch.equal(pb.binmax_int8_call(*args), pb.binmax_int8_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("bw", [32, 64])
@pytest.mark.parametrize("Q", [1, 8, 17, 129, 256, 300])
@pytest.mark.parametrize("cap,d", [(8192, D), (8192 + 64, D), (4096, 196)])
def test_binmax_int8_kernel_query_tiles(cuda_device, cap, d, Q, bw):
    # each query tile of the launch plan, past one 256-query tile, a last
    # row tile of 64 rows, and d no multiple of 16 (4-byte row copies)
    rng = np.random.default_rng(11)
    E = rng.standard_normal((cap, d)).astype(np.float32)
    E[cap - 9:] = 0
    E_q, sc = quantize_rows(torch.from_numpy(E).to(cuda_device))
    q_i8, q_scale = pb.quantize_queries(_queries(12, Q, cuda_device, d))
    args = (E_q, sc.reshape(-1), q_i8, q_scale, bw)
    assert torch.equal(pb.binmax_int8_call(*args), pb.binmax_int8_reference(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("cap,count,Q,k,bw,crafted", [
    (1024, 1000, 16, 10, None, False), (4096, 4000, 16, 2048, None, False),
    (32768, 32000, 16, 1024, None, False), (1024, 5, 16, 10, None, False),
    (4096, 4000, 16, 20, 128, False),
    # the single-pass route's size at each query tile of the launch plan
    (4096, 1939, 1, 20, None, False), (4096, 1939, 17, 20, None, False),
    (4096, 1939, 256, 20, None, False), (4096, 1939, 300, 20, None, False),
    # bins of one and of several 128-row chunks; crafted ties exact
    (4096, 3001, 256, 8, 128, True), (8192, 7000, 40, 10, 512, True),
    (4096, 3000, 16, 16, None, True),
    # k = 8192 over one and two splits
    (16384, 16000, 1, 8192, None, True), (16384, 9000, 3, 8192, None, True)])
def test_fused_topk_int8_kernel_matches_plain(cuda_device, cap, count, Q, k, bw, crafted):
    if crafted:  # small integers, unit scales, integer queries: exact sums
        g = torch.Generator(device=cuda_device).manual_seed(2)
        E_q = torch.randint(-2, 3, (cap, D), generator=g, device=cuda_device).to(torch.int8)
        E_q[count:] = 0
        sc = torch.ones(cap, device=cuda_device)
        q = torch.randint(-1, 2, (Q, D), generator=g, device=cuda_device).float()
    else:
        E_q, sc = _rows(2, cap, count, cuda_device)
        q = _queries(3, Q, cuda_device)
    v1, i1 = pf.fused_topk_int8_raw(E_q, sc, count, q, k, bw)
    v2, i2 = pf.fused_topk_int8_reference(E_q, sc, count, q, k, bw)
    fin = torch.isfinite(v2)
    assert torch.equal(torch.isfinite(v1), fin)
    if crafted:
        assert torch.equal(v1[fin], v2[fin]) and torch.equal(i1[fin], i2[fin])
        return
    torch.testing.assert_close(v1[fin], v2[fin], rtol=1e-5, atol=1e-5)
    bad = (i1 != i2) & fin
    if bad.any():  # only near-ties may swap
        rows = i1[bad].long()
        qb = q.to(torch.bfloat16).double()[bad.nonzero()[:, 0]]
        exact = (qb * E_q[rows].double()).sum(1) * sc[rows].double()
        assert (exact - v2[bad].double()).abs().max().item() <= 2e-5


def _float_rows(seed, cap, count, dev, dtype, crafted=False, d=D):
    rng = np.random.default_rng(seed)
    if crafted:  # small integers: every partial sum exact
        E = rng.integers(-2, 3, (cap, d)).astype(np.float32)
    else:
        E = rng.standard_normal((cap, d)).astype(np.float32)
        E /= np.linalg.norm(E, axis=1, keepdims=True)
    E[count:] = 0
    return torch.from_numpy(E).to(dev, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap,Q,d,bw,crafted", [
    (8192, 1, D, 32, False), (8192, 70, D, 64, False), (16384, 256, D, 32, False),
    (8192, 9, D, 32, True),
    # each query-tile width, and past one 256-wide tile
    (8192, 8, D, 8, False), (8192, 100, D, 128, False), (8192, 300, D, 64, False),
    (8192, 300, D, 32, True),
    # d no multiple of the 32-deep k-step; bins below 8 rows
    (4096, 16, 200, 8, False), (4096, 256, 200, 128, True), (4096, 20, D, 4, True),
    # 1,000 row tiles: no multiple of the persistent grid's stride
    (128000, 256, D, 64, False), (128000, 1, D, 16, False)])
def test_binmax_kernel_matches_plain(cuda_device, dtype, cap, Q, d, bw, crafted):
    E = _float_rows(4, cap, cap - 13, cuda_device, dtype, crafted, d)
    q = (torch.randint(-1, 2, (Q, d), device=cuda_device).float() if crafted
         else _queries(5, Q, cuda_device, d))
    out, ref = pb.binmax_call(E, q, bw), pb.binmax_reference(E, q, bw)
    if crafted:
        assert torch.equal(out, ref)
    else:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)


def _assert_topk_close(v1, i1, v2, i2, exact):
    fin = torch.isfinite(v2)
    assert torch.equal(torch.isfinite(v1), fin)
    if exact:
        assert torch.equal(v1[fin], v2[fin]) and torch.equal(i1[fin], i2[fin])
        return
    torch.testing.assert_close(v1[fin], v2[fin], rtol=0, atol=1e-5)
    bad = (i1 != i2) & fin
    # only near-ties may swap: the swapped-in ids score within 2e-5
    assert bad.sum().item() <= max(2, fin.sum().item() // 100)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap,count,k,bw,crafted", [
    (1024, 1000, 10, None, False), (4096, 4000, 1024, None, False),
    (4096, 4001, 20, 128, False), (1024, 5, 10, None, False),
    (4096, 3000, 16, None, True), (4096, 3000, 8, 128, True)])
def test_fused_topk_kernel_matches_plain(cuda_device, dtype, cap, count, k, bw, crafted):
    E = _float_rows(6, cap, count, cuda_device, dtype, crafted)
    q = (torch.randint(-1, 2, (16, D), device=cuda_device).float() if crafted
         else _queries(7, 16, cuda_device))
    v1, i1 = pf.fused_topk_raw(E, count, q, k, bw)
    v2, i2 = pf.fused_topk_reference(E, count, q, k, bw)
    _assert_topk_close(v1, i1, v2, i2, crafted)


def _fine_case(seed, fine_dtype, dev, nblocks=64, Q=8, L=24, shared=0):
    """A fine copy and per-query lists of distinct blocks with dead,
    partial and full slots; with ``shared`` > 0 every list draws from the
    first ``shared`` blocks, so several queries probe each block, each
    pair with its own vcnt, and the dead slots point at block 0."""
    rng = np.random.default_rng(seed)
    E = rng.standard_normal((nblocks * pivf.SLAB, D)).astype(np.float32)
    E /= np.linalg.norm(E, axis=1, keepdims=True)
    Et = torch.from_numpy(E).to(dev)
    if fine_dtype == "int8":
        qv, sc = quantize_rows(Et)
        E_c3, sc3 = qv.view(nblocks, pivf.SLAB, D), sc.view(nblocks, pivf.SLAB)
    elif fine_dtype == "int4":
        E_c3, sc3 = quantize_int4_blocks(Et, nblocks, pivf.SLAB)
    else:
        E_c3, sc3 = Et.to(torch.bfloat16).view(nblocks, pivf.SLAB, D), None
    pool = shared or nblocks
    blk = np.stack([rng.choice(pool, L, replace=False) for _ in range(Q)]).astype(np.int32)
    # dead, partial (below and above half a slab, odd) and full slots
    vcnt = rng.choice([0, 1, 77, 100, 129, 256, 256], (Q, L)).astype(np.int32)
    if shared:
        blk[vcnt == 0] = 0  # dead slots at block 0, as block_lists writes them
    return (E_c3, sc3, _queries(seed + 1, Q, dev), torch.from_numpy(blk).to(dev),
            torch.from_numpy(vcnt).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("fine_dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("Q,L,shared", [
    (8, 24, 0),
    # one query (P = 1, no sort); many queries over blocks shared with
    # per-pair vcnt and dead slots at block 0 (P = 16 sorted pairs)
    (1, 24, 30), (300, 40, 48)])
def test_fine_scores_kernel_matches_plain(cuda_device, fine_dtype, Q, L, shared):
    E_c3, sc3, q, blk, vcnt = _fine_case(8, fine_dtype, cuda_device, Q=Q, L=L, shared=shared)
    out = pivf.fine_scores_call(E_c3, sc3, q, blk, vcnt)
    ref = pivf.fine_scores_reference(E_c3, sc3, q, blk, vcnt)
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(out), fin)
    torch.testing.assert_close(out[fin], ref[fin], rtol=0, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("fine_dtype", ["bf16", "int8", "int4"])
def test_fine_scores_chunks_bit_equal(cuda_device, fine_dtype):
    # the entry point called directly: one pair a CTA in list order, and 16
    # pairs a CTA sorted by block, give the same scores bit for bit (each
    # score is the same lanes' sums in the same order)
    from modular_rag_system_tpu_torch import kernels

    E_c3, sc3, q, blk, vcnt = _fine_case(11, fine_dtype, cuda_device, Q=300, L=40, shared=48)
    mode = pivf._fine_mode(E_c3)
    qb, blk, vcnt, sc = pivf._kernel_operands(E_c3, sc3, q, blk, vcnt, mode)
    Q, L = blk.shape
    _, perm = pivf.fine_pair_keys(blk, vcnt, Q, E_c3.shape[0])
    outs = []
    for P, order in ((1, None), (16, perm)):
        out = torch.full((Q, L * pivf.SLAB), float("nan"), device=cuda_device)
        kernels.launch(
            "fine_scores", E_c3.data_ptr(), pivf._MODE_IDS[mode], sc.data_ptr(),
            qb.data_ptr(), blk.data_ptr(), vcnt.data_ptr(),
            None if order is None else order.data_ptr(), Q, L, E_c3.shape[2], P,
            out.data_ptr(), torch.cuda.current_stream(cuda_device).cuda_stream)
        outs.append(out)
    torch.cuda.synchronize()
    assert not outs[1].isnan().any()  # every position written
    assert torch.equal(outs[0], outs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("fine_dtype,k,L,Q,shared", [
    ("bf16", 20, 24, 8, 0), ("int8", 128, 24, 8, 0), ("int8", 20, 300, 8, 0),
    ("int4", 20, 24, 8, 0), ("int4", 128, 300, 8, 0),
    # more queries than one tile; blocks shared by many queries, per-pair
    # vcnt, dead slots at block 0
    ("bf16", 20, 40, 40, 60), ("int8", 20, 24, 300, 48), ("int4", 20, 40, 70, 60),
    ("bf16", 300, 100, 20, 120), ("int4", 100, 24, 9, 30),
    # the largest k: one CTA a tile, no merge
    ("int8", 8192, 300, 3, 0), ("bf16", 8192, 60, 2, 80)])
def test_fine_topk_kernel_matches_plain(cuda_device, fine_dtype, k, L, Q, shared):
    E_c3, sc3, q, blk, vcnt = _fine_case(9, fine_dtype, cuda_device, nblocks=400, Q=Q, L=L,
                                         shared=shared)
    v1, s1 = pivf.fine_call(E_c3, sc3, q, blk, vcnt, k)
    v2, s2 = pivf.fine_topk_reference(E_c3, sc3, q, blk, vcnt, k)
    _assert_topk_close(v1, s1, v2, s2, False)
    # the dump path selects the same slots with the same scores, bit for
    # bit (the JAX package's invariant: the selecting kernel's values are
    # fine_scores' own arithmetic)
    xv, xs = pivf.fine_call_xla(E_c3, sc3, q, blk, vcnt, k)
    assert torch.equal(s1, xs) and torch.equal(v1, xv)


@pytest.mark.cuda
@pytest.mark.parametrize("fine_dtype", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("Q,L,shared,dup", [
    (8, 24, 0, False),
    # one query (each pair its own chunk, no sort); blocks shared by many
    # queries with per-pair vcnt and dead slots at block 0 (runs longer
    # than a chunk); every odd row a copy of the row before it, so the
    # maximum ties with its copy and the certificate keeps both
    (1, 24, 30, False), (1, 24, 30, True), (8, 24, 30, True), (300, 40, 48, False),
    (300, 40, 48, True)])
def test_fine_binmax_kernel_matches_plain(cuda_device, fine_dtype, Q, L, shared, dup):
    E_c3, sc3, q, blk, vcnt = _fine_case(10, fine_dtype, cuda_device, Q=Q, L=L, shared=shared)
    if dup:  # stored rows: an int4 row holds logical rows r and r + 128
        E_c3[:, 1::2] = E_c3[:, 0::2]
        if sc3 is not None:
            sc3[:, 1::2] = sc3[:, 0::2]
    counts = torch.full(blk.shape, -1, dtype=torch.int32, device=cuda_device)
    out = pivf.fine_binmax_call(E_c3, sc3, q, blk, vcnt, cand_counts=counts)
    ref = pivf.fine_binmax_reference(E_c3, sc3, q, blk, vcnt)
    assert out.shape == blk.shape
    assert torch.equal(torch.isfinite(out), vcnt > 0)
    fin = torch.isfinite(ref)
    assert torch.equal(torch.isfinite(out), fin)
    torch.testing.assert_close(out[fin], ref[fin], rtol=0, atol=1e-5)
    # and the row maximum of the dump kernel, which scores with the same code
    dump = pivf.fine_scores_call(E_c3, sc3, q, blk, vcnt)
    assert torch.equal(out, dump.view(*blk.shape, pivf.SLAB).amax(dim=2))
    # every live pair rescored at least its maximum's row, at most its rows
    live = vcnt > 0
    assert (counts[live] >= 1).all() and (counts[live] <= vcnt[live]).all()
    assert (counts[~live] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap,count,k,kb,bw,crafted,Q,shared", [
    (8192, 8000, 10, 13, 32, False, 16, False), (16384, 16001, 100, 103, 64, False, 16, False),
    (8192, 7001, 16, 19, 32, True, 16, False),   # crafted ties, a count inside a bin
    (8192, 8000, 100, 2, 32, False, 16, False),  # kb x bin_width < k
    (8192, 5, 10, 13, 32, False, 16, False),     # fewer live rows than k
    # all queries list the same bins (runs longer than a chunk), with
    # crafted ties; Q = 256 at the engine's k and kb
    (8192, 8000, 10, 13, 32, False, 16, True), (8192, 7001, 16, 19, 32, True, 16, True),
    (16384, 16001, 100, 103, 64, False, 16, True), (65536, 65000, 10, 14, 32, False, 256, True),
    (65536, 65000, 100, 102, 32, False, 256, False), (8192, 8000, 10, 14, 32, False, 1, False)])
def test_rescan_kernel_matches_plain(cuda_device, dtype, cap, count, k, kb, bw, crafted, Q,
                                     shared):
    E = _float_rows(11, cap, count, cuda_device, dtype, crafted)
    q = (torch.randint(-1, 2, (Q, D), device=cuda_device).float() if crafted
         else _queries(12, Q, cuda_device))
    rng = np.random.default_rng(13)
    if shared:  # one set of bins with the straddling one, in another order for each query
        first = rng.permutation(cap // bw)[:kb]
        first[0] = first[0] if (first == count // bw).any() else count // bw
        bins = np.stack([rng.permutation(first) for _ in range(Q)]).astype(np.int32)
    else:
        bins = np.stack([rng.permutation(cap // bw)[:kb] for _ in range(Q)]).astype(np.int32)
    bins[:, 0] = np.where((bins[:, 1:] == count // bw).any(axis=1), bins[:, 0], count // bw)
    bins = torch.from_numpy(bins).to(cuda_device)
    v1, i1 = pb.rescan_call(E, bins, count, q, k, bw)
    v2, i2 = pb.rescan_reference(E, bins, count, q, k, bw)
    _assert_topk_close(v1, i1, v2, i2, crafted)
    assert (i1[~torch.isfinite(v1)] == -1).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,L,H,dh", [(3, 40, 3, 32), (2, 128, 12, 32), (2, 600, 2, 64),
                                      (1, 70, 2, 128), (2, 33, 4, 8),
                                      # one key, one or two 32-key tiles, a tile and one
                                      (2, 1, 3, 32), (3, 32, 4, 32), (2, 64, 3, 32),
                                      (2, 65, 3, 64), (2, 2048, 4, 32),
                                      # dh no multiple of 16; short rows at dh 8 and 128
                                      (2, 100, 3, 40), (5, 16, 3, 8), (2, 20, 3, 128),
                                      # the engine's shape
                                      (256, 32, 12, 32)])
def test_mea_attention_kernel_matches_plain(cuda_device, dtype, B, L, H, dh):
    g = torch.Generator(device=cuda_device).manual_seed(14)
    q, k, v = (torch.randn((B, L, H, dh), generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    pad = torch.ones((B, L), dtype=torch.int32, device=cuda_device)
    if B > 3:  # ragged lengths, as the engine's batches have them
        lengths = torch.randint(1, L + 1, (B, 1), generator=g, device=cuda_device)
        pad = (torch.arange(L, device=cuda_device) < lengths).to(torch.int32)
    pad[0, L * 5 // 8:] = 0  # ragged padding
    pad[-1] = 0 if B > 1 else pad[-1]  # an all-padding batch row
    out = pfa.mea_attention(q, k, v, pad)
    ref = pfa.mea_attention_reference(q, k, v, pad)
    assert out.dtype == dtype and torch.isfinite(out).all()
    d = (out.float() - ref.float()).abs()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7 * ref.float().abs() + 1e-5
    assert (d <= tol).all(), d.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,L,H,scatter", [
    # at the Hopper design's threshold and one below it (the tile template)
    (2, pfa.LONG_FROM - 1, 3, False), (2, pfa.LONG_FROM, 3, False),
    # a key tile and one: L no multiple of the design's 128-key tile
    (3, 4097, 2, False),
    # ModernBERT's 8,192 positions: a ragged tail and an all-padding row
    (2, 8192, 2, False),
    # padded keys scattered through every key tile; ragged lengths
    (2, 2048, 2, True), (5, 3000, 2, False)])
def test_mea_attention_long_design_matches_plain(cuda_device, B, L, H, scatter):
    from modular_rag_system_tpu_torch import kernels
    from modular_rag_system_tpu_torch.utils.profiling import TRACER

    dh = 64  # the one head width the Hopper design takes
    g = torch.Generator(device=cuda_device).manual_seed(16)
    q, k, v = (torch.randn((B, L, H, dh), generator=g, device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    pad = torch.ones((B, L), dtype=torch.int32, device=cuda_device)
    if B > 3:
        lengths = torch.randint(1, L + 1, (B, 1), generator=g, device=cuda_device)
        pad = (torch.arange(L, device=cuda_device) < lengths).to(torch.int32)
    pad[0, L * 5 // 8:] = 0
    pad[-1] = 0
    if scatter:
        pad[0] = (torch.rand(L, generator=g, device=cuda_device) > 0.3).to(torch.int32)
    before = dict(kernels.launches)
    TRACER.reset()
    TRACER.enable()
    try:
        out = pfa.mea_attention(q, k, v, pad)
        torch.cuda.synchronize()
        counted = TRACER.counters().get("attn.full_long_launches", 0)
    finally:
        TRACER.disable()
        TRACER.reset()
    assert kernels.launches["mea_attention"] == before["mea_attention"] + 1
    assert counted == pfa.full_design(L, dh, torch.bfloat16) == int(L >= pfa.LONG_FROM)
    ref = pfa.mea_attention_reference(q, k, v, pad)
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
    d = (out.float() - ref.float()).abs()
    assert (d <= 2.0**-7 * ref.float().abs() + 1e-5).all(), d.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("w", [4, 64])
# one 32-key tile; 64-key tiles, the band inside one and across several;
# ModernBERT's 8,192 positions
@pytest.mark.parametrize("L", [20, 64, 200, 2048, 8192])
def test_mea_attention_window_matches_plain(cuda_device, dtype, L, w, dh):
    B, H = 3, 2
    g = torch.Generator(device=cuda_device).manual_seed(15)
    q, k, v = (torch.randn((B, L, H, dh), generator=g, device=cuda_device).to(dtype)
               for _ in range(3))
    pad = torch.ones((B, L), dtype=torch.int32, device=cuda_device)
    pad[0, L * 5 // 8:] = 0  # a padded tail: its far rows have no live key in their band
    pad[-1] = 0  # an all-padding batch row
    out = pfa.mea_attention(q, k, v, pad, window=w)
    ref = pfa.mea_attention_reference(q, k, v, pad, window=w)
    assert out.dtype == dtype and torch.isfinite(out).all()
    d = (out.float() - ref.float()).abs()
    tol = 1e-5 if dtype == torch.float32 else 2.0**-7 * ref.float().abs() + 1e-5
    assert (d <= tol).all(), d.max().item()
    # the rows with no live key in their band are zeros in both
    dead = torch.zeros((B, L), dtype=torch.bool, device=cuda_device)
    dead[0, L * 5 // 8 + w:] = True
    dead[-1] = True
    assert (out[dead] == 0).all() and (ref[dead] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cap,count,Q,k,bw,crafted", [
    # the engine's size at each query tile of the launch plan
    (4096, 1939, 1, 10, None, False), (4096, 1939, 17, 10, None, False),
    (4096, 1939, 256, 10, None, False), (4096, 1939, 300, 10, None, False),
    (4096, 3001, 300, 16, None, True),
    # count below one 128-row split; count no multiple of 128 with bins
    (1024, 50, 17, 10, None, False), (4096, 1000, 17, 10, 128, False),
    (4096, 3001, 256, 8, 128, True), (4096, 4001, 9, 20, 32, False),
    # bins of several chunks (a carried bin minimum)
    (8192, 7000, 40, 10, 512, True),
    # k > count: empty slots; k = 8192 over one and two splits
    (1024, 700, 20, 1000, None, False), (16384, 16000, 1, 8192, None, True),
    (16384, 9000, 3, 8192, None, True), (16384, 16000, 4, 2048, None, False)])
def test_fused_topk_kernel_launch_plans(cuda_device, dtype, cap, count, Q, k, bw, crafted):
    E = _float_rows(8, cap, count, cuda_device, dtype, crafted)
    q = (torch.randint(-1, 2, (Q, D), device=cuda_device).float() if crafted
         else _queries(9, Q, cuda_device))
    v1, i1 = pf.fused_topk_raw(E, count, q, k, bw)
    v2, i2 = pf.fused_topk_reference(E, count, q, k, bw)
    _assert_topk_close(v1, i1, v2, i2, crafted)


@pytest.mark.cuda
def test_exact_topk_peak_memory(cuda_device):
    # the blocked exact top-k against the whole-matrix selection it
    # replaced: the same ids, a fraction of the transient memory
    from modular_rag_system_tpu_torch.ops import exact as pexact

    cap, Q, k = 1 << 20, 256, 100
    E = _float_rows(15, cap, cap, cuda_device, torch.float32)
    q = _queries(16, Q, cuda_device)
    count = cap - 5

    def whole():
        s = q @ E.T
        col = torch.arange(cap, device=cuda_device)
        s = torch.where(col[None, :] < count, s, float("-inf"))
        v, p = pexact.stable_topk(s, k)
        return v, p.to(torch.int32)

    def peak(fn):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    (vw, iw), whole_bytes = peak(whole)
    (vb, ib), block_bytes = peak(lambda: pexact.exact_topk_raw(E, count, q, k,
                                                               block_rows=65536))
    # the blocks' products may be summed in another order than the whole
    # matrix's: scores within 1e-5, ids equal but for near-ties
    torch.testing.assert_close(vb, vw, rtol=0, atol=1e-5)
    assert (ib != iw).sum().item() <= Q * k // 1000
    assert whole_bytes >= 4 * Q * cap * 4  # scores, the mask's copy, the sort
    # one block's scores and its stable sort (values, int64 positions and
    # scratch: about 12 times the scores), the running lists, slack
    assert block_bytes <= 16 * Q * 65536 * 4 + 4 * Q * k * 8 + (64 << 20)
    assert 2 * block_bytes <= whole_bytes


# ---------------------------------------------------------------------------
# clip_adamw: the trainer's update over flat f32 buffers

# the shipped encoder's 13,439,232 parameters, and odd tails
ADAMW_SIZES = [13_439_232, 1, 3, 1_000_003]
# a warm-up step at lr 0, then three chained steps
ADAMW_STEPS = [(1, 0.0), (2, 1e-3), (3, 2e-3), (4, 3e-3)]


def _adamw_grad(gen, n, norm, dev):
    """A gradient of magnitudes spread over orders, scaled to ``norm``."""
    g = torch.randn(n, generator=gen, device=dev) * torch.exp(
        2.0 * torch.randn(n, generator=gen, device=dev))
    return g * (norm / g.norm())


def _assert_adamw_close(got, ref, what):
    tol = 1e-6 * (ref.abs() + ref.abs().max())
    d = (got - ref).abs()
    assert (d <= tol).all(), f"{what}: max |d| {d.max().item():.3e}"


def _double(s):
    # a model group of two ranks holding the same split segment
    return s * 2.0


@pytest.mark.cuda
@pytest.mark.parametrize("reduce_split", [None, _double], ids=["one_rank", "model_group"])
@pytest.mark.parametrize("split_at", ["start", "mid", "end"])
@pytest.mark.parametrize("clipped", [False, True])
@pytest.mark.parametrize("n", ADAMW_SIZES)
def test_clip_adamw_kernel_matches_plain(cuda_device, n, clipped, split_at, reduce_split):
    split = {"start": 0, "mid": 7 * n // 13, "end": n}[split_at]
    gen = torch.Generator(device=cuda_device).manual_seed(n % 1000 + 2 * clipped)
    p = torch.randn(n, generator=gen, device=cuda_device) * 0.05
    kern = [p, torch.zeros_like(p), torch.zeros_like(p)]
    plain = [p.clone(), torch.zeros_like(p), torch.zeros_like(p)]
    for count, lr in ADAMW_STEPS:
        g = _adamw_grad(gen, n, 3.0 if clipped else 0.3, cuda_device)
        h = pca.adamw_scalars(lr, count, 0.01, 1.0)
        nk = pca.clip_adamw(kern[0], g, kern[1], kern[2], split, h, reduce_split)
        nr = pca.clip_adamw_reference(plain[0], g, plain[1], plain[2], split, h, reduce_split)
        torch.cuda.synchronize()
        assert (nr.item() >= 1.0) == clipped
        assert abs(nk.item() - nr.item()) <= 1e-6 * nr.item(), (nk.item(), nr.item())
        for name, a, b in zip(("p", "mu", "nu"), kern, plain):
            _assert_adamw_close(a, b, f"step {count} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("clipped", [False, True])
def test_clip_adamw_kernel_repeats_bit_for_bit(cuda_device, clipped):
    n = ADAMW_SIZES[0]
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    p = torch.randn(n, generator=gen, device=cuda_device) * 0.05
    runs = [[p.clone(), torch.zeros_like(p), torch.zeros_like(p)] for _ in range(2)]
    for count, lr in ADAMW_STEPS:
        g = _adamw_grad(gen, n, 3.0 if clipped else 0.3, cuda_device)
        h = pca.adamw_scalars(lr, count, 0.01, 1.0)
        norms = [pca.clip_adamw(b[0], g, b[1], b[2], 7 * n // 13, h).item() for b in runs]
        assert norms[0] == norms[1]
        for a, b in zip(*runs):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_trainer_update_launches_two_kernels(cuda_device):
    # the shipped encoder's architecture (68 tensors): the update is the
    # gradient's concatenation and the two clip_adamw launches
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from modular_rag_system_tpu_torch import kernels
    from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer

    enc = MiniLMEncoder(dim=384, max_seq_len=128, batch_size=16, num_layers=4, num_heads=12,
                        mlp_dim=1536, vocab_size=16384, device=cuda_device)
    trainer = ContrastiveTrainer(enc, learning_rate=1e-3)
    assert trainer.flat_params.numel() == ADAMW_SIZES[0] and len(trainer.params) == 68
    qs = [f"question number {i} about topic {i % 5}" for i in range(16)]
    ps = [f"passage {i} answering the question on topic {i % 5}" for i in range(16)]
    trainer.step(qs, ps)
    before = dict(kernels.launches)
    trainer.step(qs, ps)
    for name in ("clip_adamw_norm", "clip_adamw_apply"):
        assert kernels.launches[name] - before[name] == 1, name
    loss, _ = trainer._loss(qs, ps)
    grads = dict(zip(trainer.params, torch.autograd.grad(loss, list(trainer.params.values()))))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        trainer._update(grads)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) <= 3, names
    assert sum("clip_adamw_norm_kernel" in x for x in names) == 1, names
    assert sum("clip_adamw_apply_kernel" in x for x in names) == 1, names
