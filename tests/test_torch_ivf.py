"""The port's ivf tier (k-means, IVF2, the fine stage, DeviceIndex tiers
"ivf" and "auto") against the JAX package's, on the CPU.

The same numpy inputs (``np.random.default_rng``) go through both
packages; JAX's Pallas kernels run in interpret mode, as its own tests
run them, and the port's wrappers run their plain versions (the CUDA
kernels are held against those on the card, ``tests/test_torch_kernels.py``).

Tolerances and their reasons:

* k-means: f32 products in both; the cluster sums are taken in another
  order, so centroids agree within 1e-5 and labels exactly on separable
  data.
* The build's fill and the fine copies are bit-equal: the same gathers,
  the same bf16 rounding, int8 quantization bit-exact with XLA.
* Fine-stage scores: bf16(q) . row in both, exact products summed in f32
  in another order: within 1e-6 on unit-scale scores; the -inf pattern
  and the slot ids equal.
* The int4 fine copy: packed bytes and scales bit for bit (the compiled
  JAX code multiplies absmax by the f32 reciprocal of 7, and so does the
  port), after the fill and after ``update_rows``.  Its 4-bit scores only
  rank candidates, which the master rescores: ids equal, scores within
  1e-5.
* ``fine_binmax`` is the row maximum of the dump, exactly (the plain
  versions share one scoring function), and within 1e-6 of the JAX kernel.
* Index searches: inputs are bf16-representable, so the fused/two-pass
  fallback (bf16 products in the port, true f32 products in JAX on the
  CPU) sees the same products; ids equal, scores within 1e-6.
"""

import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modular_rag_system_tpu.index import DeviceIndex as JaxIndex
from modular_rag_system_tpu.ops import ivf2 as jivf
from modular_rag_system_tpu.ops import kmeans as jkm
from modular_rag_system_tpu.ops import quantize as jquant
from modular_rag_system_tpu_torch.index import DeviceIndex
from modular_rag_system_tpu_torch.ops import ivf2 as pivf
from modular_rag_system_tpu_torch.ops import kmeans as pkm
from modular_rag_system_tpu_torch.ops import quantize as pquant


def _t(x):
    return torch.from_numpy(np.array(x))


def _bf16_exact(x):
    """Round f32 values to the nearest bf16 value, kept as f32."""
    return np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return _bf16_exact(x / np.linalg.norm(x, axis=1, keepdims=True))


def _clustered(rng, n_clusters, per, d, spread=0.15):
    centers = rng.standard_normal((n_clusters, d)).astype(np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    pts = centers[:, None, :] + spread * rng.standard_normal(
        (n_clusters, per, d)).astype(np.float32)
    pts = pts.reshape(-1, d)
    return _bf16_exact(pts / np.linalg.norm(pts, axis=1, keepdims=True))


def _jax_arrays(iv):
    """A JAX IVF2's arrays as numpy, for ``IVF2.from_numpy``."""
    return {"centroids": np.asarray(iv.centroids), "E_c3": np.asarray(iv.E_c3),
            "scales3": None if iv.scales3 is None else np.asarray(iv.scales3),
            "perm": np.asarray(iv.perm), "inv_perm": np.asarray(iv.inv_perm),
            "blk_start": np.asarray(iv.blk_start), "nblk": np.asarray(iv.nblk),
            "counts": np.asarray(iv.counts),
            "block_cluster": np.asarray(iv.block_cluster)}


def _assert_same_build(jiv, piv):
    np.testing.assert_array_equal(np.asarray(jiv.E_c3).astype(np.float32),
                                  piv.E_c3.float().numpy())
    if jiv.scales3 is not None:
        np.testing.assert_array_equal(np.asarray(jiv.scales3), piv.scales3.numpy())
    for name in ("perm", "inv_perm", "blk_start", "nblk", "counts"):
        np.testing.assert_array_equal(np.asarray(getattr(jiv, name)),
                                      getattr(piv, name).numpy(), err_msg=name)


# ---------------------------------------------------------------------------
# k-means
def test_init_centroids_match_jax(rng):
    E = _unit(rng, 300, 32)
    np.testing.assert_array_equal(jkm.init_centroids_from_rows(E, 300, 12),
                                  pkm.init_centroids_from_rows(E, 300, 12))


@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_kmeans_fit_matches_jax(rng, store):
    E = np.zeros((4096, 32), np.float32)
    count = 16 * 200
    E[:count] = _clustered(rng, 16, 200, 32)[rng.permutation(count)]
    init = jkm.init_centroids_from_rows(E, count, 16)
    jc, jl = jkm.kmeans_fit(jnp.asarray(E).astype(store), jnp.int32(count),
                            jnp.asarray(init), iters=6, batch=1024)
    pc, pl_ = pkm.kmeans_fit(_t(E).to(getattr(torch, store)), count, init, iters=6,
                             batch=1024)
    np.testing.assert_array_equal(np.asarray(jl), pl_.numpy())
    assert (pl_[count:] == -1).all() and (pl_[:count] >= 0).all()
    np.testing.assert_allclose(np.asarray(jc), pc.numpy(), rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# IVF2 build
@pytest.mark.parametrize("fine_dtype", ["bf16", "int8", "int4"])
def test_warm_start_build_bit_equal(rng, fine_dtype):
    E = np.zeros((4096, 32), np.float32)
    count = 2500
    E[:count] = _unit(rng, count, 32)
    jiv = jivf.IVF2.build(jnp.asarray(E), count, n_clusters=9, iters=3,
                          fine_dtype=fine_dtype)
    warm = (np.asarray(jiv.centroids), jiv.labels_host())
    jw = jivf.IVF2.build(jnp.asarray(E), count, fine_dtype=fine_dtype, warm_start=warm)
    piv = pivf.IVF2.build(_t(E), count, fine_dtype=fine_dtype, warm_start=warm)
    assert piv.warm_started and piv.built == count
    _assert_same_build(jw, piv)
    np.testing.assert_array_equal(piv.labels_host(), warm[1])
    np.testing.assert_array_equal(np.asarray(jw.block_cluster), piv.block_cluster.numpy())
    if fine_dtype == "int4":
        assert piv.E_c3.shape[1] == pivf.SLAB // 2 and piv.E_c3.dtype == torch.int8
        assert piv.fine_bytes() * 2 == piv.nblocks * pivf.SLAB * 32


# ---------------------------------------------------------------------------
# the int4 fine copy: packing, fill, row updates
def test_int4_blocks_bit_exact(rng):
    x = (rng.standard_normal((4 * 256, 48)) * rng.uniform(0.01, 5, (1024, 1))).astype(
        np.float32)
    x[3] = x[700] = 0.0  # zero rows stay dead: scale 0
    jp, js = jax.jit(functools.partial(jquant.quantize_int4_blocks, nb=4, slab=256))(
        jnp.asarray(x))
    pp, ps = pquant.quantize_int4_blocks(_t(x), 4, 256)
    assert pp.shape == (4, 128, 48) and pp.dtype == torch.int8
    np.testing.assert_array_equal(np.asarray(jp), pp.numpy())
    np.testing.assert_array_equal(np.asarray(js), ps.numpy())
    assert ps[0, 3].item() == 0.0 and ps[2, 700 - 512].item() == 0.0
    np.testing.assert_array_equal(np.asarray(jquant.unpack_int4_blocks(jp, js)),
                                  pquant.unpack_int4_blocks(pp, ps).numpy())


def _int4_pair(rng, n=2500, d=32, clusters=9):
    E = np.zeros((4096, d), np.float32)
    E[:n] = _unit(rng, n, d)
    jiv = jivf.IVF2.build(jnp.asarray(E), n, n_clusters=clusters, iters=3,
                          fine_dtype="int4")
    piv = pivf.IVF2.from_numpy(_jax_arrays(jiv), n, "int4", device="cpu")
    return E, jiv, piv


def test_int4_update_rows_bit_exact(rng):
    E, jiv, piv = _int4_pair(rng)
    perm = np.asarray(jiv.perm)
    # both rows of one packed byte row: slots s and s + SLAB / 2 of a block
    s_hi = next(s for s in range(0, len(perm), pivf.SLAB)
                if perm[s] >= 0 and perm[s + pivf.SLAB // 2] >= 0)
    pair = perm[[s_hi, s_hi + pivf.SLAB // 2]]
    others = np.setdiff1d(np.arange(40), pair)[:6]
    rows = np.concatenate([pair, others, [3000]])  # 3000 is past built: dropped
    mat = np.array(_unit(rng, len(rows), E.shape[1]))  # writable
    for iv in (jiv, piv):
        iv.update_rows(rows, mat)
    _assert_same_build(jiv, piv)
    assert piv.stale_rows == jiv.stale_rows == len(rows) - 1
    # the two nibbles of the shared bytes are the two rows' own values
    got = pquant.unpack_int4_values(piv.E_c3[s_hi // pivf.SLAB])
    cen = piv.centroids[piv.block_cluster[s_hi // pivf.SLAB].long()]
    for j, off in enumerate((0, pivf.SLAB // 2)):
        qv, _ = pquant.int4_scale_and_values(_t(mat[j:j + 1]) - cen)
        np.testing.assert_array_equal(got[s_hi % pivf.SLAB + off].numpy(), qv[0].numpy())
    # a delete (zero row: the residual is -centroid) and a resurrect
    for iv in (jiv, piv):
        iv.update_rows(pair[:1], None)
    _assert_same_build(jiv, piv)
    for iv in (jiv, piv):
        iv.update_rows(pair[:1], mat[:1])
    _assert_same_build(jiv, piv)


def test_int4_fine_copy_raises(rng):
    # what the int4 copy still refuses, with the JAX package's messages: a
    # row update on an instance made without its block -> cluster table
    E, jiv, piv = _int4_pair(rng, n=600, clusters=4)
    jbare = jivf.IVF2(jiv.centroids, jiv.E_c3, jiv.scales3, jiv.perm, jiv.inv_perm,
                      jiv.blk_start, jiv.nblk, jiv.counts, jiv.built, jiv.nprobe, "int4")
    pbare = pivf.IVF2(piv.centroids, piv.E_c3, piv.scales3, piv.perm, piv.inv_perm,
                      piv.blk_start, piv.nblk, piv.counts, piv.built, "int4")
    msgs = []
    for bare in (jbare, pbare):
        with pytest.raises(ValueError, match="block_cluster") as err:
            bare.update_rows(np.asarray([0]), E[:1])
        msgs.append(str(err.value))
    assert msgs[0] == msgs[1]
    with pytest.raises(ValueError, match="ivf_fine_dtype"):
        DeviceIndex(dim=32, tier="ivf", ivf_fine_dtype="int2", device="cpu")


def test_int4_refusals_match_jax(rng, monkeypatch):
    E, jiv, piv = _int4_pair(rng, n=1024, clusters=4)
    q = _unit(rng, 4, 32)
    L = ((jiv.slots_for_nprobe(4) + 3) // 4) * 4
    monkeypatch.setattr(jivf, "_RESCORE_MAX_BYTES", 1024)
    monkeypatch.setattr(pivf, "_RESCORE_MAX_BYTES", 1024)
    with pytest.raises(ValueError, match="master rescore") as jerr:
        jivf.ivf2_search_core(
            jnp.asarray(E), jiv.E_c3, jiv.scales3, jiv.perm, jiv.centroids, jiv.blk_start,
            jiv.nblk, jiv.counts, jnp.int32(1024), jnp.int32(1024), jnp.asarray(q),
            k=10, nprobe=4, L=L, tail_max=0, interpret=True)
    args = (_t(E), piv.E_c3, piv.scales3, piv.perm, piv.centroids, piv.blk_start, piv.nblk,
            piv.counts, 1024, 1024, _t(q))
    with pytest.raises(ValueError, match="master rescore") as perr:
        pivf.ivf2_search_core(*args, k=10, nprobe=4, L=L, tail_max=0)
    assert str(perr.value) == str(jerr.value)
    # an explicit refine_extra overrides the default's budget check
    _, rows = pivf.ivf2_search_core(*args, k=10, nprobe=4, L=L, tail_max=0, refine_extra=100)
    assert rows.shape == (4, 10) and (rows >= 0).all()
    # a bias meets the selecting path: refused before anything is read
    Lbig = 2 * jivf._DUMP_VMEM_BYTES // (jivf.SLAB * 4)
    blk = np.zeros((1, Lbig), np.int32)
    with pytest.raises(ValueError, match="score-dump path") as jerr:
        jivf.fine_call_auto(jiv.E_c3, jiv.scales3, jnp.asarray(q[:1]), jnp.asarray(blk),
                            jnp.asarray(blk), 10, 4, True,
                            bias=jnp.zeros((1, Lbig), jnp.float32))
    with pytest.raises(ValueError, match="score-dump path") as perr:
        pivf.fine_call_auto(piv.E_c3, piv.scales3, _t(q[:1]), _t(blk), _t(blk), 10,
                            bias=torch.zeros((1, Lbig)))
    assert str(perr.value) == str(jerr.value)
    assert re.search(r"Q=1 L=\d+", str(perr.value))


@pytest.mark.parametrize("balance", [0.0, 1.5])
def test_cold_build_matches_jax(rng, balance):
    # separable clusters of unequal size; the largest is three tight
    # sub-clusters, so the split pass has work with a separable outcome
    d = 32
    big = rng.standard_normal(d).astype(np.float32)
    subs = [big / np.linalg.norm(big) + 0.4 * u / np.linalg.norm(u)
            for u in rng.standard_normal((3, d)).astype(np.float32)]
    parts = [s_ + 0.02 * rng.standard_normal((300, d)).astype(np.float32) for s_ in subs]
    parts += [_clustered(rng, 1, n, d, spread=0.05) for n in (300, 300, 200, 200, 100)]
    E = np.concatenate(parts)
    E = _bf16_exact(E / np.linalg.norm(E, axis=1, keepdims=True))
    E = E[rng.permutation(len(E))]
    count = len(E)
    jiv = jivf.IVF2.build(jnp.asarray(E), count, n_clusters=8, iters=5,
                          fine_dtype="int8", balance=balance)
    piv = pivf.IVF2.build(_t(E), count, n_clusters=8, iters=5, fine_dtype="int8",
                          balance=balance)
    assert piv.n_clusters == jiv.n_clusters and not piv.warm_started
    np.testing.assert_allclose(np.asarray(jiv.centroids), piv.centroids.numpy(),
                               rtol=0, atol=1e-5)
    _assert_same_build(jiv, piv)


def test_lbg_split_seeds_match_jax():
    cents = np.eye(4, 16, dtype=np.float32)
    cnts = np.array([900, 10, 500, 40])
    a = jivf.lbg_split_seeds(cents, cnts, 300, np.random.default_rng(0))
    b = pivf.lbg_split_seeds(cents, cnts, 300, np.random.default_rng(0))
    np.testing.assert_array_equal(a, b)
    assert pivf.lbg_split_seeds(cents, cnts, 1000, np.random.default_rng(0)) is None


# ---------------------------------------------------------------------------
# search half
def _probe_lists(rng, jiv, Q, nprobe, d):
    q = _unit(rng, Q, d)
    _, probes = jax.lax.top_k(jnp.asarray(q) @ jiv.centroids.T, nprobe)
    L = jiv.slots_for_nprobe(nprobe)
    L = ((L + 3) // 4) * 4
    return q, np.asarray(probes), L


def test_block_lists_exact(rng):
    E = _unit(rng, 3000, 32)
    jiv = jivf.IVF2.build(jnp.asarray(E), 3000, n_clusters=10, iters=3)
    _, probes, L = _probe_lists(rng, jiv, 6, 4, 32)
    jb, jv = jivf.block_lists(jnp.asarray(probes), jiv.blk_start, jiv.nblk,
                              jiv.counts, L + 8)
    pb, pv = pivf.block_lists(_t(probes), _t(jiv.blk_start), _t(jiv.nblk),
                              _t(jiv.counts), L + 8)
    np.testing.assert_array_equal(np.asarray(jb), pb.numpy())
    np.testing.assert_array_equal(np.asarray(jv), pv.numpy())
    jc = jivf.block_lists(jnp.asarray(probes), jiv.blk_start, jiv.nblk, jiv.counts,
                          L + 8, return_clusters=True)[2]
    pb2, pv2, pc = pivf.block_lists(_t(probes), _t(jiv.blk_start), _t(jiv.nblk),
                                    _t(jiv.counts), L + 8, return_clusters=True)
    assert torch.equal(pb2, pb) and torch.equal(pv2, pv)
    np.testing.assert_array_equal(np.asarray(jc), pc.numpy())


def test_auto_u_and_dump_rule_match_jax():
    for L in (1, 4, 7, 8, 12, 13, 4096, 4100):
        assert pivf.auto_u(L) == jivf.auto_u(L)
        for Q in (1, 16, 256, 4096):
            assert pivf._use_dump(Q, L) == jivf._use_dump(Q, L)


@pytest.mark.parametrize("fine_dtype", ["bf16", "int8", "int4"])
def test_fine_stage_plain_matches_jax(rng, fine_dtype):
    d = 64
    E = _unit(rng, 2048, d)
    jiv = jivf.IVF2.build(jnp.asarray(E), 2048, n_clusters=6, iters=3,
                          fine_dtype=fine_dtype)
    q, probes, L = _probe_lists(rng, jiv, 4, 3, d)
    jb, jv = jivf.block_lists(jnp.asarray(probes), jiv.blk_start, jiv.nblk,
                              jiv.counts, L)
    sc = jiv.scales3 if jiv.scales3 is not None else jnp.zeros((1, 1), jnp.float32)
    E_c3 = pivf._from_numpy(np.asarray(jiv.E_c3))
    sc_p = None if jiv.scales3 is None else _t(jiv.scales3)
    blk, vcnt = _t(jb), _t(jv)
    # the dump kernel: same -inf pattern, scores to f32 summation order
    js = np.asarray(jivf.fine_scores_call(jiv.E_c3, sc, jnp.asarray(q), jb, jv, 4, True))
    ps = pivf.fine_scores_call(E_c3, sc_p, _t(q), blk, vcnt).numpy()
    np.testing.assert_array_equal(np.isfinite(js), np.isfinite(ps))
    fin = np.isfinite(js)
    np.testing.assert_allclose(js[fin], ps[fin], rtol=0, atol=1e-6)
    # the selecting kernel: slots equal, ties to the lowest slot
    kf = 12
    jv_, jsl = jivf.fine_call(jiv.E_c3, sc, jnp.asarray(q), jb, jv, kf, 4, True)
    pv_, psl = pivf.fine_call(E_c3, sc_p, _t(q), blk, vcnt, kf)
    np.testing.assert_array_equal(np.asarray(jsl), psl.numpy())
    np.testing.assert_allclose(np.asarray(jv_), pv_.numpy(), rtol=0, atol=1e-6)
    # the dump path's ids equal the selecting kernel's (the JAX invariant)
    xv, xsl = pivf.fine_call_xla(E_c3, sc_p, _t(q), blk, vcnt, kf)
    np.testing.assert_array_equal(xsl.numpy(), psl.numpy())
    # the maxima probe: the row maximum of the dump, -inf for a dead slot
    pm = pivf.fine_binmax_call(E_c3, sc_p, _t(q), blk, vcnt)
    assert pm.shape == blk.shape
    np.testing.assert_array_equal(pm.numpy(), ps.reshape(4, L, pivf.SLAB).max(axis=2))
    np.testing.assert_array_equal(np.isfinite(pm.numpy()), np.asarray(jv) > 0)
    jm = np.asarray(jivf._fine_binmax_call(jiv.E_c3, sc, jnp.asarray(q), jb, jv, 4, True))
    fin = np.isfinite(jm)
    np.testing.assert_array_equal(fin, np.isfinite(pm.numpy()))
    np.testing.assert_allclose(jm[fin], pm.numpy()[fin], rtol=0, atol=1e-6)


def test_fine_call_xla_bias_matches_jax(rng):
    E, jiv, piv = _int4_pair(rng, n=2048, d=64, clusters=6)
    q, probes, L = _probe_lists(rng, jiv, 4, 3, 64)
    jb, jv, jc = jivf.block_lists(jnp.asarray(probes), jiv.blk_start, jiv.nblk,
                                  jiv.counts, L, return_clusters=True)
    cs = q @ np.asarray(jiv.centroids).T
    bias = np.take_along_axis(cs, np.asarray(jc), axis=1)
    kf = 300  # past the iterative selection's k: the sort branch
    jv_, jsl = jivf.fine_call_xla(jiv.E_c3, jiv.scales3, jnp.asarray(q), jb, jv, kf, 4, True,
                                  bias=jnp.asarray(bias))
    pv_, psl = pivf.fine_call_xla(piv.E_c3, piv.scales3, _t(q), _t(jb), _t(jv), kf,
                                  bias=_t(bias))
    jv_, pv_ = np.asarray(jv_), pv_.numpy()
    np.testing.assert_allclose(jv_, pv_, rtol=0, atol=1e-6)
    # 4-bit scores tie often: equal slots wherever the score is not tied
    # with a neighbour's within the summation-order tolerance
    same = np.asarray(jsl) == psl.numpy()
    gap = np.minimum(np.abs(np.diff(jv_, axis=1, prepend=np.inf)),
                     np.abs(np.diff(jv_, axis=1, append=-np.inf)))
    assert (same | (gap <= 2e-6)).all()
    assert same.mean() > 0.95


def test_fine_topk_ties_by_lowest_slot():
    # two identical blocks: every score ties with its copy, so the lower
    # slot of each pair must win, on both the selecting and the dump path
    E_c3 = torch.zeros((4, pivf.SLAB, 16), dtype=torch.bfloat16)
    E_c3[1] = E_c3[3] = torch.randn(pivf.SLAB, 16, generator=torch.Generator().manual_seed(0))
    q = torch.randn(2, 16, generator=torch.Generator().manual_seed(1))
    blk = torch.tensor([[3, 1, 0, 0], [1, 3, 0, 0]], dtype=torch.int32)
    vcnt = torch.tensor([[256, 256, 0, 0], [256, 256, 0, 0]], dtype=torch.int32)
    v, s = pivf.fine_call(E_c3, None, q, blk, vcnt, 20)
    xv, xs = pivf.fine_call_xla(E_c3, None, q, blk, vcnt, 20)
    assert torch.equal(s, xs) and torch.equal(v, xv)
    # tied pairs are adjacent, the block-1 slot first
    assert (s[:, 0::2] // pivf.SLAB == 1).all()
    assert torch.equal(s[:, 1::2], s[:, 0::2] + 2 * pivf.SLAB)


def _work_items(keys, perm, Q, L, QB, G, nblocks):
    """The fine_topk kernel's split of the sorted pairs, in Python: per
    (query tile, CTA g) the items that start in the CTA's share of the
    tile's live pairs -> [(tile, block, [(query, slot), ...])]."""
    keys, perm = keys.numpy(), perm.numpy()
    items = []
    for tile in range(-(-Q // QB)):
        base = tile * (nblocks + 1)
        lo, hi = np.searchsorted(keys, base), np.searchsorted(keys, base + nblocks)
        n = hi - lo
        for g in range(G):
            plo, phi = lo + n * g // G, lo + n * (g + 1) // G
            while plo < phi and plo > lo and keys[plo] == keys[plo - 1]:
                plo += 1
            p = plo
            while p < phi:
                e = p
                while e < hi and keys[e] == keys[p]:
                    e += 1
                items.append((tile, int(keys[p] - base),
                              [divmod(int(x), L) for x in perm[p:e]]))
                p = e
    return items


@pytest.mark.parametrize("QB,G", [(1, 1), (2, 1), (2, 3), (4, 7), (32, 5)])
def test_fine_topk_pair_table(rng, QB, G):
    # the pair table against a loop over (query, slot): dead slots at block
    # 0 beside a live block 0, one block with another vcnt for a second
    # query of the tile, a slot listed twice, random lists
    Q, L, nblocks = 9, 12, 7
    blk = rng.integers(0, nblocks, (Q, L)).astype(np.int32)
    vcnt = rng.choice([0, 1, 77, 129, 256], (Q, L)).astype(np.int32)
    blk[0, :3], vcnt[0, :3] = 0, [0, 256, 0]  # dead block-0 slots around a live one
    blk[1, 0], vcnt[1, 0] = 0, 0
    blk[0, 3], vcnt[0, 3] = 3, 10  # block 3 for queries 0 and 1, two vcnts
    blk[1, 3], vcnt[1, 3] = 3, 77
    blk[2, 4:6], vcnt[2, 4:6] = 5, 200  # a slot listed twice
    keys, perm = pivf.fine_pair_keys(torch.from_numpy(blk), torch.from_numpy(vcnt), QB,
                                     nblocks)
    items = _work_items(keys, perm, Q, L, QB, G, nblocks)
    # each live pair in exactly one work item, and no dead pair in any
    got = sorted(pair for _, _, pairs in items for pair in pairs)
    want = sorted((i, j) for i in range(Q) for j in range(L) if vcnt[i, j] > 0)
    assert got == want
    # one item per (query tile, block) that a live pair of the tile lists,
    # holding exactly those pairs in (query, slot) order
    groups = {}
    for i, j in want:
        groups.setdefault((i // QB, int(blk[i, j])), []).append((i, j))
    assert {(t, b): pairs for t, b, pairs in items} == groups
    assert len(items) == len(groups)
    assert all(blk[i, j] == b and i // QB == t for t, b, pairs in items for i, j in pairs)


@pytest.mark.parametrize("Q,L,k,d,mode", [
    (16, 4608, 20, 768, "bf16"), (128, 80, 20, 768, "int4"), (1, 80, 8192, 1024, "bf16"),
    (300, 80, 128, 768, "int8"), (4, 1500, 128, 768, "int8"), (300, 80, 8192, 1024, "bf16"),
    (9, 3, 4096, 16, "int4"), (65535, 8, 20, 768, "bf16")])
def test_fine_topk_plan_fits(Q, L, k, d, mode):
    cfg, QB, G = pivf.fine_topk_plan(Q, L, k, d, mode, 132)
    assert 1 <= QB <= min(Q, 32)
    assert cfg == 0 or QB < min(8, Q) or pivf.fine_topk_smem(0, d, mode, min(8, Q), k) > 232_448
    assert pivf.fine_topk_smem(cfg, d, mode, QB, k) <= 232_448
    kp, _ = pivf.fine_topk_keys(k)
    assert G == 1 or G * kp <= pivf._FINE_MERGE_KEYS
    assert -(-Q // QB) <= 65535  # the grid's query tiles


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("Q,L,d", [
    (1, 80, 768), (1, 4096, 768), (2, 80, 768), (128, 80, 768), (256, 80, 768),
    (300, 40, 1024), (65535, 8, 16), (16, 4608, 1024)])
def test_fine_scores_plan(Q, L, d, mode):
    from modular_rag_system_tpu_torch import kernels

    P = pivf.fine_scores_plan(Q, L, d, mode, 132)
    assert 1 <= P <= pivf._FINE_SCORES_MAX_P
    assert P * d * 4 <= kernels.SMEM_BYTES  # the chunk's queries in shared memory
    if Q == 1 or mode == "int4":
        assert P == 1  # one CTA a pair, no sort
    elif Q * L >= 4 * 132 * pivf._FINE_SCORES_MAX_P:
        assert P == pivf._FINE_SCORES_MAX_P  # the smoke's int8 Q = 256 among them
    assert -(-Q * L // P) <= 2**31 - 1  # the grid
    # within the kernel's static bound on P
    src = (kernels.KERNEL_DIR / "fine_scores.cu").read_text()
    assert P <= int(re.search(r"constexpr int MAX_P = (\d+);", src).group(1))


def _scores_walk(order, blk, vcnt, P):
    """The fine_scores kernel's walk, in Python: CTA c takes the pairs
    order[cP : cP + P] (flat positions in (Q, L)) and reads each run of
    consecutive live pairs with one block once -> [(c, block, [pairs])]."""
    runs = []
    for c in range(-(-len(order) // P)):
        chunk = [int(x) for x in order[c * P:(c + 1) * P]]
        s = 0
        while s < len(chunk):
            if vcnt[chunk[s]] <= 0:
                s += 1
                continue
            e = s + 1
            while e < len(chunk) and vcnt[chunk[e]] > 0 and blk[chunk[e]] == blk[chunk[s]]:
                e += 1
            runs.append((c, int(blk[chunk[s]]), chunk[s:e]))
            s = e
    return runs


@pytest.mark.parametrize("P,shared", [(1, 0), (1, 9), (2, 9), (5, 12), (16, 9), (16, 40)])
def test_fine_scores_walk(rng, P, shared):
    # the kernel's chunk walk over fine_pair_keys' order (in order at P = 1)
    # against a plain loop: every position of every pair's output row is
    # written once, with the plain version's score or -inf
    Q, L, nblocks, d = 23, 8, 48, 16
    pool = shared or nblocks
    blk = np.stack([rng.choice(pool, L, replace=False) for _ in range(Q)]).astype(np.int32)
    vcnt = rng.choice([0, 1, 77, 129, 256], (Q, L)).astype(np.int32)
    blk[vcnt == 0] = 0  # dead slots at block 0, as block_lists writes them
    E_c3 = _t(_bf16_exact(rng.standard_normal((nblocks, pivf.SLAB, d)))).to(torch.bfloat16)
    q = _t(_bf16_exact(rng.standard_normal((Q, d))))
    tb, tv = torch.from_numpy(blk), torch.from_numpy(vcnt)
    order = (pivf.fine_pair_keys(tb, tv, Q, nblocks)[1].numpy() if P > 1
             else np.arange(Q * L))
    fb, fv = blk.reshape(-1), vcnt.reshape(-1)
    runs = _scores_walk(order, fb, fv, P)

    out = np.full((Q * L, pivf.SLAB), np.nan, np.float64)
    writes = np.zeros((Q * L, pivf.SLAB), np.int64)
    for x in range(Q * L):  # each CTA's -inf fill of its pairs
        out[x, max(fv[x], 0):] = -np.inf
        writes[x, max(fv[x], 0):] += 1
    Ef, qf = E_c3.double().numpy(), q.double().numpy()
    for _, b, pairs in runs:
        rows = Ef[b, :max(fv[x] for x in pairs)]  # the run's slab, read once
        for x in pairs:
            out[x, :fv[x]] = rows[:fv[x]] @ qf[x // L]
            writes[x, :fv[x]] += 1
    assert (writes == 1).all()
    ref = pivf.fine_scores_reference(E_c3, None, q, tb, tv).double().numpy()
    ref = ref.reshape(Q * L, pivf.SLAB)
    assert np.array_equal(np.isfinite(out), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0, atol=1e-5)
    # a chunk reads each block at most once (its pairs are sorted by
    # block), so the reads are at most the unique blocks + the chunks
    per_chunk = [(c, b) for c, b, _ in runs]
    if P > 1:
        assert len(per_chunk) == len(set(per_chunk))
    uniq = len({int(b) for b, v in zip(fb, fv) if v > 0})
    assert len(runs) <= uniq + -(-Q * L // P)
    assert sorted(x for _, _, pairs in runs for x in pairs) == \
        [x for x in range(Q * L) if fv[x] > 0]


def _certified(s, e, vc):
    """fine_binmax's certificate in Python: the live rows (r < vc) whose
    upper bound s + e reaches the largest lower bound max(s - e)."""
    live = np.arange(len(s)) < vc
    M = (s - e)[live].max()
    return np.nonzero(live & (s + e >= M))[0]


@pytest.mark.parametrize("case", ["random", "duplicates", "closer_than_e", "extremes"])
@pytest.mark.parametrize("vc", [1, 77, 129, 256])
def test_fine_binmax_certificate(rng, case, vc):
    # the tensor cores' score s of a row is within e of its exact score x:
    # for every perturbation of x by up to e the candidates hold the row of
    # the maximum, so the maximum of their exact scores is the maximum
    for trial in range(200):
        x = rng.standard_normal(pivf.SLAB) * 0.1
        e = rng.uniform(0.2, 1.0, pivf.SLAB) * 2.0**-14
        top = int(rng.integers(0, vc))
        if case == "duplicates":  # the maximum and other rows repeated
            x[1::2] = x[0::2]
            e[1::2] = e[0::2]
        elif case == "closer_than_e":  # rows within e of the maximum
            near = rng.integers(0, vc, 6)
            x[near] = x[:vc].max() - rng.uniform(0, 2, 6) * e[near]
        x[top] = x[:vc].max() + (0.0 if case == "duplicates" else e[top] * trial / 200)
        delta = rng.uniform(-1, 1, pivf.SLAB) * e
        if case == "extremes":  # the worst case: the maximum low, the others high
            delta = np.where(x == x[:vc].max(), -e, e)
        cand = _certified(x + delta, e, vc)
        assert (cand < vc).all()
        assert x[cand].max() == x[:vc].max()
        assert np.argmax(x[:vc]) in cand


def _binmax_walk(keys, perm, P, G, nblocks, W):
    """The fine_binmax kernel's walk in Python: CTA b takes the windows b,
    b + G, ... of W pairs (sorted by block, or in list order where ``perm``
    is None) and reads a slab once for each run of a window's live pairs
    that list it; sorted, the first dead pair ends a CTA's walk, in list
    order a dead pair is skipped -> [(cta, [flat positions])]."""
    walk = []
    for b in range(min(G, -(-P // W))):
        for w0 in range(b * W, P, G * W):
            s, wend = w0, min(w0 + W, P)
            while s < wend:
                if keys[s] >= nblocks:
                    break
                e = s + 1
                while e < wend and keys[e] == keys[s]:
                    e += 1
                walk.append((b, [int(perm[x]) if perm is not None else x for x in range(s, e)]))
                s = e
            else:
                continue
            if perm is not None:  # sorted: the rest are dead
                break
    return walk


@pytest.mark.parametrize("Q,shared,G,W", [(1, 0, 264, 1), (1, 0, 3, 1), (23, 0, 264, 8),
                                          (23, 9, 264, 8), (23, 9, 5, 8), (40, 12, 1, 8),
                                          (23, 9, 7, 3)])
def test_fine_binmax_walk(rng, Q, shared, G, W):
    # the kernel's walk over fine_binmax_pairs' sorted pairs against the
    # plain version: every live pair's maximum written once from one read
    # of its slab, dead pairs -inf, slab reads at most the unique slabs +
    # one a window of 8 pairs
    L, nblocks, d = 8, 48, 16
    pool = shared or nblocks
    blk = np.stack([rng.choice(pool, L, replace=False) for _ in range(Q)]).astype(np.int32)
    vcnt = rng.choice([0, 1, 77, 129, 256], (Q, L)).astype(np.int32)
    blk[vcnt == 0] = 0  # dead slots at block 0, as block_lists writes them
    E_c3 = _t(_bf16_exact(rng.standard_normal((nblocks, pivf.SLAB, d)))).to(torch.bfloat16)
    q = _t(_bf16_exact(rng.standard_normal((Q, d))))
    tb, tv = torch.from_numpy(blk), torch.from_numpy(vcnt)
    keys, perm = pivf.fine_binmax_pairs(tb, tv, nblocks)
    assert (perm is None) == (Q == 1)
    fb, fv = blk.reshape(-1), vcnt.reshape(-1)
    if perm is None:  # list order: the kernel keys a dead pair past every block
        keys = np.where(fv > 0, fb, nblocks)
    else:
        keys, perm = keys.numpy(), perm.numpy()
        assert (keys == np.where(fv > 0, fb, nblocks)[perm]).all()
        assert (np.diff(keys) >= 0).all() and sorted(perm.tolist()) == list(range(Q * L))
    walk = _binmax_walk(keys, perm, Q * L, G, nblocks, W)

    out = np.where(fv > 0, np.nan, -np.inf)  # the dead slots' -inf
    writes = np.zeros(Q * L, np.int64)
    Ef, qf = E_c3.double().numpy(), q.double().numpy()
    for _, pairs in walk:
        assert 1 <= len(pairs) <= W <= pivf._FINE_BINMAX_COLS
        b = fb[pairs[0]]
        assert all(fb[x] == b and fv[x] > 0 for x in pairs)  # one slab read
        for x in pairs:
            out[x] = (Ef[b, :fv[x]] @ qf[x // L]).max()
            writes[x] += 1
    assert (writes == (fv > 0)).all()
    ref = pivf.fine_binmax_reference(E_c3, None, q, tb, tv).double().numpy().reshape(-1)
    assert np.array_equal(np.isfinite(out), np.isfinite(ref))
    fin = np.isfinite(ref)
    np.testing.assert_allclose(out[fin], ref[fin], rtol=0, atol=1e-5)
    uniq = len({int(b) for b, v in zip(fb, fv) if v > 0})
    assert len(walk) <= uniq + -(-int((fv > 0).sum()) // W)


@pytest.mark.parametrize("mode", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("d", [16, 384, 768, 1024])
def test_fine_binmax_smem_fits(mode, d):
    # one CTA always fits; two an SM (each within half of the SM's 233,472
    # bytes less the 1 KiB the card reserves a CTA) up to d = 768
    assert pivf.fine_binmax_smem(d, mode) <= 232_448
    if d <= 768:
        assert pivf.fine_binmax_smem(d, mode) <= 233_472 // 2 - 1024


def _jax_search(jiv, E, q, k, nprobe, built, count, tail_max):
    L = jiv.slots_for_nprobe(nprobe)
    U = jivf.auto_u(L)
    L = ((L + U - 1) // U) * U
    sc3 = jiv.scales3 if jiv.scales3 is not None else jnp.zeros((1, 1), jnp.float32)
    core = jax.jit(functools.partial(jivf.ivf2_search_core, k=k, nprobe=nprobe, L=L,
                                     tail_max=tail_max, U=U, interpret=True))
    v, r = core(jnp.asarray(E), jiv.E_c3, sc3, jiv.perm, jiv.centroids, jiv.blk_start,
                jiv.nblk, jiv.counts, jnp.int32(built), jnp.int32(count), jnp.asarray(q))
    return np.asarray(v), np.asarray(r), L


@pytest.mark.parametrize("fine_dtype,store", [("bf16", "float32"), ("int8", "bfloat16"),
                                              ("int4", "float32")])
def test_ivf2_search_core_on_jax_state(rng, fine_dtype, store):
    d, cap, built, count, k = 32, 4096, 2000, 2300, 10
    E = np.zeros((cap, d), np.float32)
    E[:count] = _unit(rng, count, d)
    Em = jnp.asarray(E).astype(store)
    jiv = jivf.IVF2.build(Em, built, n_clusters=8, iters=3, fine_dtype=fine_dtype)
    q = _unit(rng, 5, d)
    jv, jr, L = _jax_search(jiv, Em, q, k, 3, built, count, 8192 // 2)
    piv = pivf.IVF2.from_numpy(_jax_arrays(jiv), built, fine_dtype, device="cpu")
    pv, pr = pivf.ivf2_search_core(
        _t(E).to(getattr(torch, store)), piv.E_c3, piv.scales3, piv.perm, piv.centroids,
        piv.blk_start, piv.nblk, piv.counts, built, count, _t(q), k=k, nprobe=3, L=L,
        tail_max=4096)
    np.testing.assert_array_equal(jr, pr.numpy())
    # int4: the master rescores 4-bit-ranked candidates (the stated 1e-5)
    np.testing.assert_allclose(jv, pv.numpy(), rtol=0,
                               atol=1e-5 if fine_dtype == "int4" else 1e-6)
    assert (pr.numpy() >= built).any()  # the tail took part


# ---------------------------------------------------------------------------
# DeviceIndex tiers ivf and auto
_KW = dict(ivf_clusters=8, ivf_nprobe=4, ivf_rebuild_min=512)


def _pair(store="float32", tier="ivf", **kw):
    kw = {**_KW, **kw}
    return (JaxIndex(dim=32, tier=tier, store_dtype=store, **kw),
            DeviceIndex(dim=32, tier=tier, store_dtype=store, device="cpu", **kw))


def _same_search(jidx, pidx, q, k):
    js, jr = jidx.search(q, k)
    ps, pr = pidx.search(q, k)
    fin = np.isfinite(js)
    np.testing.assert_array_equal(fin, np.isfinite(ps))
    np.testing.assert_array_equal(jr[fin], pr[fin])
    np.testing.assert_allclose(js[fin], ps[fin], rtol=0, atol=1e-6)
    return pr


@pytest.mark.parametrize("store,fine", [("float32", "bf16"), ("bfloat16", "int8"),
                                        ("float32", "int4")])
def test_ivf_index_lifecycle_matches_jax(rng, store, fine):
    jidx, pidx = _pair(store, ivf_fine_dtype=fine)
    E = _unit(rng, 3000, 32)
    q = np.concatenate([E[[5, 2100]], _unit(rng, 4, 32)])
    for idx in (jidx, pidx):
        idx.add(E[:1000])
    assert pidx.ivf_rebuilds == jidx.ivf_rebuilds == 1
    assert pidx._ivf2.built == 1000
    # the tail: appends below the threshold do not rebuild
    for idx in (jidx, pidx):
        idx.add(E[1000:1200])
    assert pidx.ivf_rebuilds == 1 and pidx._ivf2.built == 1000
    _same_search(jidx, pidx, q, 10)
    # delete a built row and resurrect it with new content
    new = _unit(rng, 1, 32)
    for idx in (jidx, pidx):
        idx.delete_rows(np.array([5, 1100]))
    _same_search(jidx, pidx, q, 10)
    for idx in (jidx, pidx):
        idx.set_rows(np.array([5]), new)
    assert pidx._ivf2.stale_rows == jidx._ivf2.stale_rows == 2
    _same_search(jidx, pidx, np.concatenate([q, new]), 10)
    # the k > 64 route (filtered refill) serves the exact fused stream
    _same_search(jidx, pidx, q, 100)
    # crossing the tail threshold rebuilds from the write path
    for idx in (jidx, pidx):
        idx.add(E[1200:])
    assert pidx.ivf_rebuilds == jidx.ivf_rebuilds == 2
    assert pidx._ivf2.built == 3000
    _same_search(jidx, pidx, q, 10)
    _same_search(jidx, pidx, q, 100)
    assert pidx._ivf2.fine_dtype == jidx._ivf2.fine_dtype == fine
    if fine != "int4":  # int4 residuals follow the centroids, equal to 1e-5 only
        _assert_same_build(jidx._ivf2, pidx._ivf2)


def test_ivf_below_build_threshold_serves_fused(rng):
    jidx, pidx = _pair(ivf_rebuild_min=32768)
    E = _unit(rng, 700, 32)
    for idx in (jidx, pidx):
        idx.add(E)
    assert pidx._ivf2 is None and pidx.effective_tier() == "ivf"
    _same_search(jidx, pidx, _unit(rng, 3, 32), 10)


@pytest.mark.parametrize("tier,store", [("fused", "float32"), ("bf16", "float32"),
                                        ("fused", "bfloat16")])
def test_streaming_tiers_match_jax(rng, tier, store):
    jidx, pidx = _pair(store, tier=tier)
    E = _unit(rng, 9000, 32)  # capacity 32768: the two-pass route
    for idx in (jidx, pidx):
        idx.add(E[:500])
    q = _unit(rng, 4, 32)
    _same_search(jidx, pidx, q, 10)  # single pass (capacity 1024)
    for idx in (jidx, pidx):
        idx.add(E[500:])
        idx.set_rows(np.array([3]), E[:1] * 0.5)
        idx.delete_rows(np.array([7]))
    assert pidx.capacity == jidx.capacity == 32768
    _same_search(jidx, pidx, q, 10)
    if tier == "bf16" and store == "float32":
        assert pidx._E_bf16 is not None and torch.equal(
            pidx._E_bf16[:9000].float(), pidx.E[:9000].to(torch.bfloat16).float())


def test_fused_bin_width_validated_as_jax():
    pidx = DeviceIndex(dim=32, tier="fused", fused_bin_width=96, device="cpu")
    pidx.add(np.ones((10, 32), np.float32))
    with pytest.raises(ValueError, match="multiple of 128"):
        pidx.search(np.ones((1, 32), np.float32), 3)


def test_auto_promotes_to_ivf(rng, monkeypatch):
    for cls in (JaxIndex, DeviceIndex):
        monkeypatch.setattr(cls, "_AUTO_IVF_ROWS", 1024)
        monkeypatch.setattr(cls, "_IVF_AUTO_INT8_ROWS", 1024)
    jidx, pidx = _pair(tier="auto", ivf_rebuild_min=64)
    E = _unit(rng, 1600, 32)
    q = _unit(rng, 3, 32)
    for idx in (jidx, pidx):
        idx.add(E[:1000])
    assert pidx.effective_tier() == "int8" and pidx._ivf2 is None
    _same_search(jidx, pidx, q, 10)
    for idx in (jidx, pidx):
        idx.add(E[1000:1024])
    # the write path promoted at exactly 1024 rows: a bf16 fine copy
    assert pidx.effective_tier() == "ivf" and pidx._ivf2.fine_dtype == "bf16"
    _same_search(jidx, pidx, q, 10)
    for idx in (jidx, pidx):
        idx.add(E[1024:])
    # past the crossover the rebuild takes the int8 fine copy
    assert pidx.ivf_rebuilds == 2 and pidx._ivf2.fine_dtype == "int8"
    assert jidx._ivf2.fine_dtype == "int8"
    _same_search(jidx, pidx, q, 10)


def test_jax_snapshot_restores_with_warm_start(rng, tmp_path):
    kw = dict(_KW, ivf_fine_dtype="int8")
    jidx = JaxIndex(dim=32, tier="ivf", **kw)
    jidx.add(_clustered(rng, 8, 150, 32))
    path = str(tmp_path / "jax.npz")
    jidx.snapshot(path)
    pidx = DeviceIndex.load(path, tier="ivf", device="cpu", **kw)
    assert pidx._ivf2.warm_started and pidx.ivf_warmstart is None
    np.testing.assert_array_equal(np.asarray(jidx._ivf2.centroids),
                                  pidx._ivf2.centroids.numpy())
    _assert_same_build(jidx._ivf2, pidx._ivf2)
    _same_search(jidx, pidx, _unit(rng, 4, 32), 10)
    # and back: the port's snapshot carries the same clustering
    pidx.snapshot(str(tmp_path / "port.npz"))
    data = np.load(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(data["ivf_labels"], jidx._ivf2.labels_host())


def test_int4_index_serves_and_syncs_nibbles(rng):
    # the JAX package's own int4 checks, on the port: at full probe the
    # master rescore returns the exact tier's rows and scores, and a
    # delete zeroes one nibble without clobbering the packed partner row
    E = _clustered(rng, 8, 250, 64)
    idx = DeviceIndex(dim=64, tier="ivf", ivf_clusters=8, ivf_nprobe=8,
                      ivf_rebuild_min=64, ivf_fine_dtype="int4", device="cpu")
    idx.add(E)
    iv = idx._ivf2
    assert iv.fine_dtype == "int4" and iv.E_c3.shape[1] == pivf.SLAB // 2
    q = _unit(rng, 4, 64) * 0.3 + E[:4] * 0.7
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    scores, rows = idx.search(q, 5)
    exact = DeviceIndex(dim=64, tier="exact", device="cpu")
    exact.add(E)
    ref_scores, ref_rows = exact.search(q, 5)
    assert [set(r) for r in rows] == [set(r) for r in ref_rows]
    np.testing.assert_allclose(scores, ref_scores, rtol=1e-5, atol=1e-5)
    slot0 = int(iv.inv_perm[0])
    half = pivf.SLAB // 2
    partner = int(iv.perm[slot0 + (half if slot0 % pivf.SLAB < half else -half)])
    idx.delete_rows(np.asarray([0]))
    s0, r0 = idx.search(E[:1], 1)
    assert r0[0, 0] != 0 or s0[0, 0] < 0.5
    if partner >= 0:
        assert idx.search(E[partner:partner + 1], 1)[1][0, 0] == partner
    idx.set_rows(np.asarray([0]), E[:1])
    assert idx.search(E[:1], 1)[1][0, 0] == 0
