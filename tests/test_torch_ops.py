"""Port ops vs the JAX package's ops, on the CPU.

The same numpy inputs (``np.random.default_rng``) go through the JAX
function (Pallas kernels in interpret mode, as the JAX tests run them)
and its counterpart in ``modular_rag_system_tpu_torch.ops``; on the CPU
the port's kernel wrappers run their plain PyTorch versions
(``tests/test_torch_kernels.py`` holds the kernels against those on
the card).

Tolerances: int8 products summed as f32 integers are exact in any order,
so pass 1 and quantization are bit-exact; f32 sums of real-valued
products differ by summation order only, hence 1e-6 on unit-scale
scores (or bit-exact where the crafted inputs make every sum exact).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modular_rag_system_tpu.index import stream_search_core as jax_stream
from modular_rag_system_tpu.ops import binmax_topk as jb
from modular_rag_system_tpu.ops import exact as jexact
from modular_rag_system_tpu.ops import fused_topk as jf
from modular_rag_system_tpu.ops.quantize import quantize_rows as jquant
from modular_rag_system_tpu_torch import index as pindex
from modular_rag_system_tpu_torch.ops import binmax_topk as pb
from modular_rag_system_tpu_torch.ops import exact as pexact
from modular_rag_system_tpu_torch.ops import fused_topk as pf
from modular_rag_system_tpu_torch.ops.quantize import quantize_rows as pquant


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def _t(x):
    return torch.from_numpy(np.array(x))


def _quantized(rng, cap, d, count):
    """(E f32 with zero rows past count, E_q int8, scales (cap,) f32)."""
    E = _unit(rng, cap, d)
    E[count:] = 0
    qv, sc = jquant(jnp.asarray(E))
    return E, np.asarray(qv), np.asarray(sc).reshape(-1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_rows_bit_exact(rng, dtype):
    x = rng.standard_normal((64, 96)).astype(np.float32) * 3.0
    x[5] = 0.0  # zero row -> scale 0
    x = np.asarray(jnp.asarray(x).astype(dtype).astype(jnp.float32))
    qj, sj = jquant(jnp.asarray(x))
    qp, sp = pquant(_t(x))
    np.testing.assert_array_equal(np.asarray(qj), qp.numpy())
    np.testing.assert_array_equal(np.asarray(sj), sp.numpy())
    assert sp[5].item() == 0.0


@pytest.mark.parametrize("ties,block_rows,store,count,k", [
    pytest.param(False, None, "float32", 300, 10, id="False"),
    pytest.param(True, None, "float32", 300, 10, id="True"),
    # blocks of fewer rows than k, and of fewer rows than count
    pytest.param(True, 7, "float32", 300, 10, id="blocks-below-k"),
    pytest.param(False, 64, "float32", 300, 10, id="blocks-below-count"),
    # a run of equal rows across the edge of two blocks
    pytest.param("straddle", 64, "float32", 300, 10, id="ties-straddle-block-edge"),
    pytest.param("straddle", 10, "float32", 300, 10, id="ties-straddle-k-blocks"),
    # a bf16 master, upcast a block at a time
    pytest.param(False, 50, "bfloat16", 300, 20, id="bf16-master"),
    pytest.param(True, 3, "bfloat16", 300, 10, id="bf16-master-ties"),
    # fewer live rows than k: the masked columns fill the last slots
    pytest.param(False, 4, "float32", 6, 10, id="count-below-k"),
    pytest.param(False, None, "bfloat16", 0, 5, id="count-zero-bf16"),
])
def test_exact_topk_matches_jax(rng, ties, block_rows, store, count, k):
    cap, d = 512, 64
    if ties is True:  # small integers: exact sums, many equal scores
        E = rng.integers(-2, 3, (cap, d)).astype(np.float32)
        q = rng.integers(-2, 3, (5, d)).astype(np.float32)
    else:
        E, q = _unit(rng, cap, d), _unit(rng, 5, d)
    if ties == "straddle":  # rows 58..69 equal, and the best for query 0
        E[58:70] = E[0]
        q[0] = E[0]
    E = np.asarray(jnp.asarray(E).astype(store).astype(jnp.float32))
    vj, ij = jexact.exact_topk(jnp.asarray(E).astype(store), jnp.int32(count),
                               jnp.asarray(q), k)
    vp, ip = pexact.exact_topk_raw(_t(E).to(getattr(torch, store)), count, _t(q), k,
                                   block_rows=block_rows)
    np.testing.assert_array_equal(np.asarray(ij), ip.numpy())
    np.testing.assert_allclose(np.asarray(vj), vp.numpy(), rtol=0, atol=1e-6)


def test_exact_block_rows_bounded():
    # the default block holds at most 256 MiB of scores (and f32 rows over
    # a bf16 master), and never fewer rows than k
    assert pexact._EXACT_BLOCK_BYTES == 1 << 28
    for Q, d, upcast, k in ((256, 768, False, 16384), (256, 768, True, 16384),
                            (1, 768, True, 10), (65536, 1024, True, 8192)):
        B = pexact.exact_block_rows(Q, d, upcast, k)
        assert B >= k
        assert B == k or B * (4 * Q + (4 * d if upcast else 0)) <= 1 << 28


@pytest.mark.parametrize("bw,Q", [(32, 7), (8, 1), (64, 16)])
def test_binmax_int8_bit_exact(rng, bw, Q):
    cap, d, count = 1024, 768, 1000
    _, E_q, sc = _quantized(rng, cap, d, count)
    q_i8, q_scale = pb.quantize_queries(_t(_unit(rng, Q, d)))
    nb = cap // bw
    ref = jb.binmax_int8_call(
        jnp.asarray(E_q), jnp.asarray(sc).reshape(nb, bw), jnp.asarray(q_i8.numpy()),
        jnp.asarray(q_scale.numpy()).reshape(1, Q), 512, bw, True)
    out = pb.binmax_int8_call(_t(E_q), _t(sc), q_i8, q_scale, bw)
    np.testing.assert_array_equal(np.asarray(ref).T, out.numpy())


@jax.jit
def _jax_quantize_queries(q):
    # the two-pass glue's lines, compiled as the serving path compiles them
    qmax = jnp.maximum(jnp.max(jnp.abs(q), axis=1, keepdims=True), 1e-12)
    q_i8 = jnp.clip(jnp.round(q / qmax * 127.0), -127, 127).astype(jnp.int8)
    return q_i8, (qmax / 127.0).reshape(-1)


def test_query_quantization_bit_exact(rng):
    q = _unit(rng, 64, 768)
    ref_i8, ref_scale = _jax_quantize_queries(jnp.asarray(q))
    q_i8, q_scale = pb.quantize_queries(_t(q))
    np.testing.assert_array_equal(np.asarray(ref_i8), q_i8.numpy())
    np.testing.assert_array_equal(np.asarray(ref_scale), q_scale.numpy())


def _fused_case(rng, case):
    cap, d = 1024, 64
    if case == "ties":
        # small integer rows, unit scales, integer queries: exact sums,
        # many tied scores -> the (score desc, id asc) order decides
        E_q = rng.integers(-2, 3, (cap, d)).astype(np.int8)
        sc = np.ones(cap, np.float32)
        q = rng.integers(-1, 2, (6, d)).astype(np.float32)
        return E_q, sc, q, 700
    _, E_q, sc = _quantized(rng, cap, d, 1000)
    return E_q, sc, _unit(rng, 6, d), (5 if case == "count<k" else 1000)


@pytest.mark.parametrize("case,k,bw", [
    ("random", 10, None), ("random", 20, 128), ("ties", 16, None),
    ("ties", 5, 128), ("count<k", 10, None), ("random", 40, None),
])
def test_fused_topk_int8_matches_jax(rng, case, k, bw):
    E_q, sc, q, count = _fused_case(rng, case)
    cap = E_q.shape[0]
    vj, ij = jf.fused_topk_int8_raw(
        jnp.asarray(E_q), jnp.asarray(sc).reshape(1, cap), jnp.int32(count),
        jnp.asarray(q), k, 256, True, bin_width=bw)
    vp, ip = pf.fused_topk_int8_raw(_t(E_q), _t(sc), count, _t(q), k, bw)
    vj, ij = np.asarray(vj), np.asarray(ij)
    fin = np.isfinite(vj)
    np.testing.assert_array_equal(fin, np.isfinite(vp.numpy()))
    np.testing.assert_allclose(vj[fin], vp.numpy()[fin], rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(ij[fin], ip.numpy()[fin])
    if case == "count<k":
        assert fin.sum(axis=1).tolist() == [count] * q.shape[0]


@pytest.mark.parametrize("master_dtype,crafted", [
    ("float32", False), ("bfloat16", False), ("bfloat16", True)])
def test_twopass_int8_master_matches_jax(rng, master_dtype, crafted):
    cap, d, count, k, bw = 8192, 64, 8000, 10, 32
    if crafted:
        # integer/16 rows and queries: bf16-exact values whose products
        # and sums are exact in f32, so scores must agree bit for bit
        E = rng.integers(-8, 9, (cap, d)).astype(np.float32) / 16
        q = rng.integers(-8, 9, (5, d)).astype(np.float32) / 16
        E[count:] = 0
    else:
        E, q = _unit(rng, cap, d), _unit(rng, 5, d)
        E[count:] = 0
    Em = np.asarray(jnp.asarray(E).astype(master_dtype).astype(jnp.float32))
    qv, sc = jquant(jnp.asarray(Em))
    sc = np.asarray(sc).reshape(-1)
    vj, ij = jax.jit(jb.twopass_topk_int8_master_raw, static_argnums=(5, 6, 7, 8))(
        qv, jnp.asarray(sc), jnp.asarray(E).astype(master_dtype), jnp.int32(count),
        jnp.asarray(q), k, 4096, bw, True)
    vp, ip = pb.twopass_topk_int8_master_raw(
        _t(np.asarray(qv)), _t(sc), _t(E).to(getattr(torch, master_dtype)), count,
        _t(q), k, bw)
    np.testing.assert_array_equal(np.asarray(ij), ip.numpy())
    if crafted:
        np.testing.assert_array_equal(np.asarray(vj), vp.numpy())
    else:
        np.testing.assert_allclose(np.asarray(vj), vp.numpy(), rtol=0, atol=1e-6)


def test_select_bins_same_set_as_jax(rng):
    # crafted ties across bins and groups: the set must match exactly
    bm = rng.integers(0, 5, (4, 512)).astype(np.float32)
    ref = np.sort(np.asarray(jb.select_bins(jnp.asarray(bm), 14)), axis=1)
    np.testing.assert_array_equal(ref, pb.select_bins(_t(bm), 14).numpy())


@pytest.mark.parametrize("master_dtype", ["float32", "bfloat16"])
def test_refine_against_master_matches_jax(rng, master_dtype):
    cap, d, k = 256, 64, 8
    E = _unit(rng, cap, d)
    q = _unit(rng, 4, d)
    rows = np.stack([rng.choice(cap, 16, replace=False) for _ in range(4)]).astype(np.int32)
    cand = rng.standard_normal((4, 16)).astype(np.float32)
    cand[0, 3] = cand[2, :5] = -np.inf  # masked candidates
    vj, ij = jb.refine_against_master(
        jnp.asarray(E).astype(master_dtype), jnp.asarray(q), jnp.asarray(rows), k,
        cand_vals=jnp.asarray(cand))
    vp, ip = pb.refine_against_master(
        _t(E).to(getattr(torch, master_dtype)), _t(q), _t(rows), k, cand_vals=_t(cand))
    np.testing.assert_array_equal(np.asarray(ij), ip.numpy())
    np.testing.assert_allclose(np.asarray(vj), vp.numpy(), rtol=0, atol=1e-6)


def test_int8_helpers_match_jax():
    for k, c in [(1, 1), (10, 4096), (10, 12), (100, 4096), (200, 4096)]:
        assert pb.int8_refine_kf(k, c) == jb.int8_refine_kf(k, c)
    for cap in (8192, 4_194_304, 8_388_608):
        assert pb.auto_bin_width(cap) == jb.auto_bin_width(cap)
    assert pb._MIN_TWOPASS_CAP == jb._MIN_TWOPASS_CAP


@pytest.mark.parametrize("cap,count,k,route", [
    (4096, 3000, 10, "single"),   # below _MIN_TWOPASS_CAP
    (8192, 7000, 10, "twopass"),
    (8192, 7000, 300, "single"),  # k >= cap / bw: the two-pass gate fails
])
def test_stream_search_core_routing(rng, monkeypatch, cap, count, k, route):
    d = 64
    E, E_q, sc = _quantized(rng, cap, d, count)
    q = _unit(rng, 3, d)
    calls = []
    for name in ("twopass_topk_int8_master_raw", "fused_topk_int8_raw"):
        fn = getattr(pindex, name)
        monkeypatch.setattr(pindex, name,
                            lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    vp, ip = pindex.stream_search_core(_t(E_q), _t(sc), _t(E), count, _t(q), k, None)
    assert calls == (["twopass_topk_int8_master_raw"] if route == "twopass"
                     else ["fused_topk_int8_raw"])
    vj, ij = jax.jit(
        lambda e, c, qq, s, m: jax_stream(e, c, qq, k, 1024, None, scales=s, master=m))(
        jnp.asarray(E_q), jnp.int32(count), jnp.asarray(q),
        jnp.asarray(sc).reshape(cap, 1), jnp.asarray(E))
    vj, ij = np.asarray(vj), np.asarray(ij)
    fin = np.isfinite(vj)
    np.testing.assert_array_equal(fin, np.isfinite(vp.numpy()))
    np.testing.assert_array_equal(ij[fin], ip.numpy()[fin])
    np.testing.assert_allclose(vj[fin], vp.numpy()[fin], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# the f32/bf16 kernels' plain versions (binmax, fused_topk, twopass)
#
# The port scores bf16(q) . bf16(row) in f32, as the TPU kernels do at
# default precision; JAX's interpret mode on the CPU multiplies f32 rows
# in true f32.  On bf16-representable inputs the two agree (exact
# products, f32 sums in another order: 1e-6), on integer-valued inputs
# bit for bit.
def _bf16_vals(x):
    return np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _float_case(rng, case, cap, d, Q):
    if case == "ties":  # small integers: exact sums, many ties
        return (rng.integers(-2, 3, (cap, d)).astype(np.float32),
                rng.integers(-1, 2, (Q, d)).astype(np.float32))
    E, q = _bf16_vals(_unit(rng, cap, d)), _bf16_vals(_unit(rng, Q, d))
    return E, q


def _close(ref, out, exact):
    if exact:
        np.testing.assert_array_equal(ref, out)
    else:
        np.testing.assert_allclose(ref, out, rtol=0, atol=1e-6)


@pytest.mark.parametrize("store,case,bw", [
    ("float32", "unit", 32), ("bfloat16", "unit", 64), ("float32", "ties", 32)])
def test_binmax_matches_jax(rng, store, case, bw):
    cap, d, Q = 2048, 64, 5
    E, q = _float_case(rng, case, cap, d, Q)
    ref = jb.binmax_call(jnp.asarray(E).astype(store), jnp.asarray(q), 512, bw, True)
    out = pb.binmax_call(_t(E).to(getattr(torch, store)), _t(q), bw)
    _close(np.asarray(ref).T, out.numpy(), case == "ties")


def test_binmax_general_f32_within_bf16_rounding(rng):
    # general f32 unit vectors: the port rounds both operands to bf16
    # (relative error <= 2^-9 each), so each product moves by at most
    # ~2^-8 of its magnitude and the sum by 2^-8 * sum|q_i e_i| <= 2^-8
    E, q = _unit(rng, 1024, 64), _unit(rng, 4, 64)
    ref = jb.binmax_call(jnp.asarray(E), jnp.asarray(q), 512, 32, True)
    out = pb.binmax_call(_t(E), _t(q), 32)
    np.testing.assert_allclose(np.asarray(ref).T, out.numpy(), rtol=0, atol=2.0**-8)


@pytest.mark.parametrize("store,case,k,count", [
    ("float32", "unit", 10, 8000), ("bfloat16", "unit", 100, 8000),
    ("float32", "ties", 16, 7001), ("float32", "unit", 10, 5)])
def test_twopass_topk_matches_jax(rng, store, case, k, count):
    cap, d, bw = 8192, 64, 32
    E, q = _float_case(rng, case, cap, d, 6)
    E[count:] = 0
    Ej = jnp.asarray(E).astype(store)
    vj, ij = jax.jit(jb.twopass_topk_raw, static_argnums=(3, 4, 5, 6))(
        Ej, jnp.int32(count), jnp.asarray(q), k, 4096, bw, True)
    vp, ip = pb.twopass_topk_raw(_t(E).to(getattr(torch, store)), count, _t(q), k, bw)
    vj, ij = np.asarray(vj), np.asarray(ij)
    fin = np.isfinite(vj)
    np.testing.assert_array_equal(fin, np.isfinite(vp.numpy()))
    np.testing.assert_array_equal(ij[fin], ip.numpy()[fin])
    _close(vj[fin], vp.numpy()[fin], case == "ties")


@pytest.mark.parametrize("store,case,k,bw,count", [
    ("float32", "unit", 10, None, 1000), ("bfloat16", "unit", 40, 128, 1000),
    ("float32", "ties", 16, None, 700), ("float32", "ties", 5, 128, 900),
    ("float32", "unit", 10, None, 5)])
def test_fused_topk_matches_jax(rng, store, case, k, bw, count):
    cap, d = 1024, 64
    E, q = _float_case(rng, case, cap, d, 8)
    vj, ij = jf.fused_topk_raw(jnp.asarray(E).astype(store), jnp.int32(count),
                               jnp.asarray(q), k, 256, True, bin_width=bw)
    vp, ip = pf.fused_topk_raw(_t(E).to(getattr(torch, store)), count, _t(q), k, bw)
    vj, ij = np.asarray(vj), np.asarray(ij)
    fin = np.isfinite(vj)
    np.testing.assert_array_equal(fin, np.isfinite(vp.numpy()))
    np.testing.assert_array_equal(ij[fin], ip.numpy()[fin])
    _close(vj[fin], vp.numpy()[fin], case == "ties")
    if count < k:
        assert fin.sum(axis=1).tolist() == [count] * q.shape[0]


@pytest.mark.parametrize("cap,k,bw,route", [
    (4096, 10, None, "fused_topk_raw"), (8192, 10, None, "twopass_topk_raw"),
    (8192, 300, None, "fused_topk_raw"), (8192, 10, 128, "fused_topk_raw")])
def test_float_stream_search_core_routing(rng, monkeypatch, cap, k, bw, route):
    d = 64
    E = _bf16_vals(_unit(rng, cap, d))
    count = cap - 100
    E[count:] = 0
    q = _bf16_vals(_unit(rng, 3, d))
    calls = []
    for name in ("twopass_topk_raw", "fused_topk_raw"):
        fn = getattr(pindex, name)
        monkeypatch.setattr(pindex, name,
                            lambda *a, _fn=fn, _n=name, **kw: calls.append(_n) or _fn(*a, **kw))
    vp, ip = pindex.stream_search_core(_t(E), None, None, count, _t(q), k, bw)
    assert calls == [route]
    vj, ij = jax.jit(lambda e, c, qq: jax_stream(e, c, qq, k, 1024, bw))(
        jnp.asarray(E), jnp.int32(count), jnp.asarray(q))
    vj, ij = np.asarray(vj), np.asarray(ij)
    fin = np.isfinite(vj)
    np.testing.assert_array_equal(ij[fin], ip.numpy()[fin])
    np.testing.assert_allclose(vj[fin], vp.numpy()[fin], rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# pass 2 in one kernel (kernel_rescan=True): rescan_call against the JAX
# Pallas kernel in interpret mode.  The port multiplies bf16 products (the
# TPU's default precision, on an f32 store too) where interpret mode
# multiplies in true f32, so rows and queries are bf16-representable: ids
# equal, scores within 1e-6 (f32 summation order), bit for bit on
# integer-valued inputs.
@pytest.mark.parametrize("store,case,k,bw,count", [
    ("float32", "unit", 10, 32, 8000), ("bfloat16", "unit", 10, 64, 8000),
    ("float32", "ties", 16, 32, 7001),   # crafted ties, a count inside a bin
    ("bfloat16", "unit", 100, 32, 8000),
    ("float32", "unit", 10, 32, 5)])     # fewer live rows than k
def test_rescan_call_matches_jax(rng, store, case, k, bw, count):
    cap, d, Q = 8192, 64, 6
    E, q = _float_case(rng, case, cap, d, Q)
    E[count:] = 0
    kb = k + 3
    # distinct bins per query, unsorted, the straddle bin among them
    bins = np.stack([rng.permutation(cap // bw)[:kb] for _ in range(Q)]).astype(np.int32)
    bins[:, 0] = min(count, cap - 1) // bw
    for r in range(Q):  # keep the row's bins distinct
        dup = np.nonzero(bins[r, 1:] == bins[r, 0])[0]
        bins[r, 1 + dup] = (bins[r, 0] + 1) % (cap // bw)
    vj, ij = jb.rescan_call(jnp.asarray(E).astype(store), jnp.asarray(bins),
                            jnp.int32(count), jnp.asarray(q), k, bw, True)
    vp, ip = pb.rescan_call(_t(E).to(getattr(torch, store)), _t(bins), count, _t(q), k, bw)
    vj, ij = np.asarray(vj), np.asarray(ij)
    fin = np.isfinite(vj)
    np.testing.assert_array_equal(fin, np.isfinite(vp.numpy()))
    np.testing.assert_array_equal(ij[fin], ip.numpy()[fin])
    _close(vj[fin], vp.numpy()[fin], case == "ties")
    assert (ip.numpy()[~fin] == -1).all()
    if count < k:
        assert (fin.sum(axis=1) <= count).all()


def test_rescan_fewer_candidates_than_k(rng):
    E, q = _float_case(rng, "unit", 1024, 64, 3)
    bins = np.array([[3, 1], [0, 31], [7, 8]], np.int32)
    vals, ids = pb.rescan_call(_t(E), _t(bins), 1024, _t(q), 100, 32)
    assert vals.shape == (3, 100) and torch.isfinite(vals[:, :64]).all()
    assert torch.isinf(vals[:, 64:]).all() and (ids[:, 64:] == -1).all()
    assert sorted(ids[0, :64].tolist()) == list(range(32, 64)) + list(range(96, 128))


def _rescan_walk(keys, P, G, W=8):
    """The rescan kernel's score launch in Python: CTA b takes the windows
    b, b + G, ... of W sorted pairs and reads a bin once for each run of
    a window's pairs that list it -> [(cta, [sorted positions])]."""
    walk = []
    for b in range(min(G, -(-P // W))):
        for w0 in range(b * W, P, G * W):
            s, wend = w0, min(w0 + W, P)
            while s < wend:
                e = s + 1
                while e < wend and keys[e] == keys[s]:
                    e += 1
                walk.append((b, list(range(s, e))))
                s = e
    return walk


@pytest.mark.parametrize("Q,kb,bw,k,count,shared,G,W", [
    (6, 13, 32, 10, 7001, False, 264, 8),
    # all queries list the same bins: runs of 16 pairs, cut by the windows
    (16, 13, 32, 10, 7001, True, 264, 8), (16, 13, 32, 10, 7001, True, 3, 8),
    (16, 13, 32, 10, 7001, True, 7, 3),
    (5, 2, 32, 100, 7001, False, 264, 8),   # kb x bin_width < k
    (1, 14, 32, 10, 7001, False, 264, 1),   # one query: each pair its own window
    (20, 5, 64, 16, 3001, True, 1, 8), (9, 7, 32, 40, 8192, False, 5, 2)])
def test_rescan_walk(rng, Q, kb, bw, k, count, shared, G, W):
    # the kernel's walk over rescan_pairs' pairs in windows of W, its scores
    # and its selection, in Python, against rescan_reference: every (query,
    # slot) key written once, each run reading one bin, bin reads at most
    # the unique bins + one a window
    cap, d = 8192, 16
    E, q = _float_case(rng, "unit", cap, d, Q)
    E[count:] = 0
    nb = cap // bw
    straddle = min(count, cap - 1) // bw  # the bin that holds count, in every list
    first = rng.permutation(nb)[:kb]
    first[0] = first[0] if (first == straddle).any() else straddle
    bins = np.stack([rng.permutation(first) if shared else rng.permutation(nb)[:kb]
                     for _ in range(Q)]).astype(np.int32)
    bins[:, 0] = np.where((bins[:, 1:] == straddle).any(axis=1), bins[:, 0], straddle)
    keys, perm = pb.rescan_pairs(_t(bins), nb)
    P, flat = Q * kb, bins.reshape(-1)
    if Q == 1:  # the list as it is: its bins are distinct, nothing to share
        assert perm is None and keys.dtype == torch.int32
        perm = np.arange(P)
    else:
        assert keys.dtype == torch.int16  # the narrowest type that holds nb - 1
        perm = perm.numpy()
        assert (np.diff(keys.numpy()) >= 0).all()
    keys = keys.numpy()
    assert sorted(perm.tolist()) == list(range(P)) and (keys == flat[perm]).all()
    walk = _rescan_walk(keys, P, G, W)

    scores = np.full((Q, kb * bw), np.nan)
    ids = np.full((Q, kb * bw), -1, np.int64)
    writes = np.zeros((Q, kb * bw), np.int64)
    qb, Eb = q.astype(np.float64), E.astype(np.float64)
    for _, pairs in walk:
        assert 1 <= len(pairs) <= W <= pb._RESCAN_COLS
        b = int(keys[pairs[0]])
        assert all(flat[perm[s]] == b for s in pairs)  # one bin read
        rows = Eb[b * bw:(b + 1) * bw]
        for s in pairs:
            i, j = divmod(int(perm[s]), kb)
            gid = b * bw + np.arange(bw)
            scores[i, j * bw:(j + 1) * bw] = np.where(gid < count, rows @ qb[i], -np.inf)
            ids[i, j * bw:(j + 1) * bw] = gid
            writes[i, j * bw:(j + 1) * bw] += 1
    assert (writes == 1).all()
    uniq = len(np.unique(flat))
    assert len(walk) <= uniq + -(-P // W)
    if shared:  # every bin a run of Q pairs, cut by the windows
        assert len(walk) == sum(len({x // W for x in range(r * Q, r * Q + Q)}) for r in range(kb))

    # the select launch: each query's best k by (score desc, id asc)
    vals = np.full((Q, k), -np.inf)
    out_ids = np.full((Q, k), -1, np.int64)
    for i in range(Q):
        live = [(-scores[i, x], ids[i, x]) for x in range(kb * bw) if np.isfinite(scores[i, x])]
        for r, (ns, gid) in enumerate(sorted(live)[:k]):
            vals[i, r], out_ids[i, r] = -ns, gid
    vr, ir = pb.rescan_reference(_t(E), _t(bins), count, _t(q), k, bw)
    np.testing.assert_array_equal(out_ids, ir.numpy())
    fin = np.isfinite(vals)
    np.testing.assert_array_equal(fin, np.isfinite(vr.numpy()))
    np.testing.assert_allclose(vals[fin], vr.numpy()[fin], rtol=0, atol=1e-5)


@pytest.mark.parametrize("P,sms,W", [
    # the smoke's k = 10 and k = 100 batches, Q = 1, a small batch, and the
    # fine_binmax lists at Q = 256 and Q = 16 on 132 SMs
    (3584, 132, 8), (26112, 132, 8), (14, 132, 1), (224, 132, 1), (20480, 132, 8),
    (1280, 132, 4), (1, 1, 1), (10**6, 1, 8)])
def test_pair_window(P, sms, W):
    # windows of at most 8 sorted pairs (a run's most columns), fewer where
    # there would be fewer than two windows an SM
    assert pb.pair_window(P, sms) == W


@pytest.mark.parametrize("nb,dtype", [(2, torch.int16), (32768, torch.int16),
                                      (32769, torch.int32)])
def test_rescan_pairs_sorted_stably(rng, nb, dtype):
    bins = rng.integers(0, nb, (7, 5)).astype(np.int32)
    bins[:, 1] = bins[:, 0]  # equal keys keep their order
    keys, perm = pb.rescan_pairs(_t(bins), nb)
    assert pb.rescan_pairs(_t(bins[:1]), nb)[1] is None  # one query: no sort
    assert keys.dtype == dtype and perm.dtype == torch.int64
    np.testing.assert_array_equal(perm.numpy(), np.argsort(bins.reshape(-1), kind="stable"))
    np.testing.assert_array_equal(keys.numpy(), np.sort(bins.reshape(-1)))


@pytest.mark.parametrize("store,k", [("float32", 10), ("bfloat16", 10), ("float32", 100)])
def test_twopass_kernel_rescan_matches_jax(rng, store, k):
    cap, d, bw, count = 8192, 64, 32, 8000
    E, q = _float_case(rng, "unit", cap, d, 6)
    E[count:] = 0
    E[100] = E[7]  # an exact tie across bins: the lower id first
    vj, ij = jax.jit(jb.twopass_topk_raw, static_argnums=(3, 4, 5, 6, 7))(
        jnp.asarray(E).astype(store), jnp.int32(count), jnp.asarray(q), k, 4096, bw, True,
        True)
    Ep = _t(E).to(getattr(torch, store))
    vp, ip = pb.twopass_topk_raw(Ep, count, _t(q), k, bw, kernel_rescan=True)
    np.testing.assert_array_equal(np.asarray(ij), ip.numpy())
    np.testing.assert_allclose(np.asarray(vj), vp.numpy(), rtol=0, atol=1e-6)
    # and the gather path it replaces: the same scoring space
    vg, ig = pb.twopass_topk_raw(Ep, count, _t(q), k, bw)
    assert torch.equal(ig, ip)
    np.testing.assert_allclose(vg.numpy(), vp.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("master_dtype", ["float32", "bfloat16"])
def test_twopass_int8_master_kernel_rescan_matches_jax(rng, master_dtype):
    cap, d, count, k, bw = 8192, 64, 8000, 10, 32
    E, q = _float_case(rng, "unit", cap, d, 5)
    E[count:] = 0
    qv, sc = jquant(jnp.asarray(E))
    sc = np.asarray(sc).reshape(-1)
    vj, ij = jax.jit(jb.twopass_topk_int8_master_raw,
                     static_argnums=(5, 6, 7, 8, 9, 10))(
        qv, jnp.asarray(sc), jnp.asarray(E).astype(master_dtype), jnp.int32(count),
        jnp.asarray(q), k, 4096, bw, True, 2, True)
    args = (_t(np.asarray(qv)), _t(sc), _t(E).to(getattr(torch, master_dtype)), count,
            _t(q), k, bw)
    vp, ip = pb.twopass_topk_int8_master_raw(*args, kernel_rescan=True)
    np.testing.assert_array_equal(np.asarray(ij), ip.numpy())
    np.testing.assert_allclose(np.asarray(vj), vp.numpy(), rtol=0, atol=1e-6)
    vg, ig = pb.twopass_topk_int8_master_raw(*args)
    assert torch.equal(ig, ip)
    np.testing.assert_allclose(vg.numpy(), vp.numpy(), rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# launch plans of the fused_topk and binmax_int8 kernels (pure Python: the
# kernels themselves run only on the card)
_SMEM = 232_448


# a row value's bytes; the ids are those of the f32/bf16 cases from before
# the int8 row type joined the plan (False: f32, True: bf16)
_ROW_BYTES = [pytest.param(4, id="False"), pytest.param(2, id="True"),
              pytest.param(1, id="int8")]


@pytest.mark.parametrize("Q,k,count,bw", [
    (256, 10, 1939, 1), (1, 10, 1939, 1), (17, 10, 50, 1), (300, 16, 3001, 1),
    (17, 10, 1000, 128), (9, 20, 4001, 32), (40, 10, 7000, 512), (20, 1000, 700, 1),
    (1, 8192, 16000, 1), (3, 8192, 9000, 1), (4, 2048, 16000, 1), (5, 10, 0, 1),
    (1024, 100, 1_000_000, 256), (1, 1, 127, 1), (8, 4096, 8191, 128)])
@pytest.mark.parametrize("row_bytes", _ROW_BYTES)
def test_fused_topk_plan_splits_cover_live_rows(Q, k, count, bw, row_bytes):
    cfg, QB, S, R = pf.fused_topk_plan(Q, k, count, 768, row_bytes, bw)
    assert R % 128 == 0 and R % bw == 0  # no bin straddles two splits
    assert S * k <= 16384  # one query's merge fits shared memory
    owner = np.zeros(count, dtype=np.int64)
    for s in range(S):
        lo, hi = s * R, min((s + 1) * R, count)
        assert hi > lo or count == 0  # no empty split
        owner[lo:hi] += 1
    assert (owner == 1).all()  # every live row in exactly one split
    assert pf.fused_topk_smem(cfg, 768, row_bytes, QB, k) <= _SMEM


@pytest.mark.parametrize("d", [8, 768, 1024])
@pytest.mark.parametrize("row_bytes", _ROW_BYTES)
def test_fused_topk_plan_smem_every_k(d, row_bytes):
    for Q in (1, 8, 9, 256, 1024):
        for k in range(1, 8193):
            cfg, QB, S, R = pf.fused_topk_plan(Q, k, 16384, d, row_bytes)
            assert 1 <= QB <= Q
            assert pf.fused_topk_smem(cfg, d, row_bytes, QB, k) <= _SMEM, (Q, k)


@pytest.mark.parametrize("k", [1, 10, 100, 128, 129, 1000, 4096, 8192])
def test_fused_topk_plan_query_tiles_cover_q(k):
    for Q in range(1, 1025):
        for row_bytes in (4, 1):
            cfg, QB, S, R = pf.fused_topk_plan(Q, k, 4096, 1024, row_bytes)
            tiles = -(-Q // QB)
            assert (tiles - 1) * QB < Q <= tiles * QB
            assert QB <= (8 if cfg in (0, 1) else 32)  # the configuration's columns
            assert pf.fused_topk_smem(cfg, 1024, row_bytes, QB, k) <= _SMEM


def test_fused_topk_plan_int8_ring():
    # the int8 ring stages 48 bytes a row (32 values + 16), a quarter-odd of
    # f32's 160; the rest of a CTA's shared memory is the same
    for cfg in range(3):
        f32 = pf.fused_topk_smem(cfg, 768, 4, 8, 10)
        i8 = pf.fused_topk_smem(cfg, 768, 1, 8, 10)
        stages = pf._FUSED_CFGS[cfg][1]
        assert f32 - i8 == stages * 128 * (160 - 48)
    with pytest.raises(ValueError):
        pf.fused_topk_smem(0, 768, 3, 8, 10)


@pytest.mark.parametrize("d", [4, 196, 384, 768, 1036])
def test_binmax_int8_plan_query_tiles(d):
    for Q in range(1, 1025):
        bq = pb.binmax_int8_plan(Q, d)
        assert bq in (16, 64, 128, 256)
        assert pb.binmax_int8_smem(bq, d) <= _SMEM
        # the narrowest tile that holds Q, unless shared memory forbids it
        if Q <= bq:
            assert all(t < Q for t in (16, 64, 128, 256) if t < bq)
        else:
            assert all(pb.binmax_int8_smem(t, d) > _SMEM for t in (128, 256) if t > bq)
