"""The port's ShardedIndex against the JAX package's, on the CPU.

The same numpy rows and queries (``np.random.default_rng``) go through
JAX's ``ShardedIndex`` on the 8 virtual CPU devices and through the
port's on ``["cpu"] * 8`` (or the same layout with fewer shards, or
(slices, chips) nested lists).  JAX's Pallas kernels run in interpret
mode, as its own tests run them; the port's wrappers run their plain
versions (the ``cuda`` tests at the end put the tiers on one card).

Tolerances: row ids equal exactly, tie order included; scores within
1e-5 (f32 products summed in another order).  Inputs are
bf16-representable, so the fused and bf16 tiers (bf16 products in the
port, true f32 products in JAX's interpret mode) see the same products.
ivf ids are compared on a build that takes JAX's clustering as its warm
start (its fill is bit-equal); a cold build's centroids agree within
1e-5 (the cluster sums are added in another order).

The JAX side is imported inside the tests, so the ``cuda`` tests also
run where JAX is not installed:

    python -m pytest tests/test_torch_sharded.py -m cuda -q --noconftest
"""

import threading

import numpy as np
import pytest
import torch

from modular_rag_system_tpu_torch.index import DeviceIndex
from modular_rag_system_tpu_torch.ops import ivf2 as pivf
from modular_rag_system_tpu_torch.ops import kmeans as pkm
from modular_rag_system_tpu_torch.parallel.mesh import (
    make_hierarchical_index_mesh,
    make_index_mesh,
)
from modular_rag_system_tpu_torch.parallel.sharded import ShardedIndex

CPU8 = ["cpu"] * 8


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


def _bf16_exact(x):
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).float().numpy()


def _unit(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return _bf16_exact(x / np.linalg.norm(x, axis=1, keepdims=True))


def _clustered(rng, n_hubs, n, d, spread=0.05):
    hubs = rng.standard_normal((n_hubs, d)).astype(np.float32)
    hubs /= np.linalg.norm(hubs, axis=1, keepdims=True)
    E = hubs[rng.integers(0, n_hubs, n)] + spread * rng.standard_normal((n, d))
    return _bf16_exact((E / np.linalg.norm(E, axis=1, keepdims=True)).astype(np.float32))


def _jax_mesh(S=8, slices=None):
    from modular_rag_system_tpu.parallel import mesh as jmesh
    from tests.conftest import cpu_mesh_devices

    if slices:
        return jmesh.make_hierarchical_index_mesh(slices, S // slices,
                                                  devices=cpu_mesh_devices(S))
    return jmesh.make_index_mesh(S, devices=cpu_mesh_devices(S))


def _pair(dim, S=8, slices=None, **kw):
    """(JAX ShardedIndex, port ShardedIndex) with the same knobs."""
    from modular_rag_system_tpu.parallel.sharded import ShardedIndex as JaxSharded

    mesh = [["cpu"] * (S // slices)] * slices if slices else ["cpu"] * S
    return (JaxSharded(dim=dim, mesh=_jax_mesh(S, slices), **kw),
            ShardedIndex(dim=dim, mesh=mesh, **kw))


def _same(jidx, pidx, q, k):
    """Ids equal exactly (ties included), scores within 1e-5."""
    js, jr = jidx.search(q, k)
    ps, pr = pidx.search(q, k)
    np.testing.assert_array_equal(np.isfinite(js), np.isfinite(ps))
    np.testing.assert_array_equal(jr, pr)
    fin = np.isfinite(js)
    np.testing.assert_allclose(ps[fin], js[fin], rtol=0, atol=1e-5)
    return pr


def _both(fn, *idxs):
    for idx in idxs:
        fn(idx)


# ---------------------------------------------------------------------------
# layouts
def test_mesh_layouts():
    assert make_index_mesh(3, device="cpu") == [torch.device("cpu")] * 3
    assert make_index_mesh(device="cpu") == [torch.device("cpu")]
    assert make_index_mesh(2, devices=["cpu", "cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="requested 4 shards but only 2 devices"):
        make_index_mesh(4, devices=["cpu", "cpu"])
    h = make_hierarchical_index_mesh(2, 3, device="cpu")
    assert [len(s) for s in h] == [3, 3]
    with pytest.raises(ValueError, match="mesh 2x4 > 6 devices"):
        make_hierarchical_index_mesh(2, 4, devices=["cpu"] * 6)


def test_cuda_layout_never_doubles_up_a_card(monkeypatch):
    # without the shards' devices, S shards need S visible cards: the
    # layout raises rather than placing two shards on one card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match=r"only 1 CUDA devices are visible.*index_devices"):
        make_index_mesh(4, device="cuda")
    assert make_index_mesh(4, devices=["cuda:0"] * 4) == [torch.device("cuda", 0)] * 4
    assert make_index_mesh(1, device="cuda") == [torch.device("cuda", 0)]


# ---------------------------------------------------------------------------
# the streaming tiers, flat and hierarchical
@pytest.mark.parametrize("tier", ["exact", "fused", "bf16", "int8"])
def test_tiers_match_jax(rng, tier):
    E = _unit(rng, 4000, 64)
    q = _unit(rng, 5, 64)
    jidx, pidx = _pair(64, tier=tier, block_rows=256)
    _both(lambda i: i.add(E), jidx, pidx)
    assert pidx.cap_s == jidx.cap_s == 512
    pr = _same(jidx, pidx, q, 10)
    # and the single-device index's ids (exact tier)
    single = DeviceIndex(dim=64, tier="exact", device="cpu")
    single.add(E)
    np.testing.assert_array_equal(pr, single.search(q, 10)[1])


@pytest.mark.parametrize("tier", ["fused", "int8"])
def test_two_pass_route_per_shard(rng, tier):
    # cap_s 8192 per shard: each shard takes the two-pass route
    # (binmax / binmax_int8 pass 1), as on the card at 5,636,096 rows
    E = _unit(rng, 9000, 32)
    q = _unit(rng, 4, 32)
    jidx, pidx = _pair(32, S=2, capacity=16384, tier=tier, block_rows=256)
    _both(lambda i: i.add(E), jidx, pidx)
    assert pidx.cap_s == 8192
    _same(jidx, pidx, q, 10)


def test_one_shard_and_eight_shards_agree(rng):
    E = _unit(rng, 1000, 64)
    q = _unit(rng, 3, 64)
    jidx, one = _pair(64, S=1, tier="exact", block_rows=256)
    eight = ShardedIndex(dim=64, mesh=CPU8, tier="exact", block_rows=256)
    _both(lambda i: i.add(E), jidx, one, eight)
    single = DeviceIndex(dim=64, tier="exact", device="cpu")
    single.add(E)
    r1 = _same(jidx, one, q, 5)
    np.testing.assert_array_equal(r1, eight.search(q, 5)[1])
    np.testing.assert_array_equal(r1, single.search(q, 5)[1])


@pytest.mark.parametrize("tier", ["fused", "int8"])
def test_tie_order_across_layouts(rng, tier):
    # duplicate rows: every score ties, the smallest global ids win on
    # every layout (a shard's lowest local row is its lowest global id)
    base = _unit(rng, 1, 64)
    E = np.tile(base, (512, 1))
    jidx, eight = _pair(64, tier=tier, block_rows=64)
    one = ShardedIndex(dim=64, mesh=["cpu"], tier=tier, block_rows=256)
    hier = ShardedIndex(dim=64, mesh=[["cpu"] * 4] * 2, tier=tier, block_rows=64)
    _both(lambda i: i.add(E), jidx, eight, one, hier)
    r = _same(jidx, eight, base, 5)
    np.testing.assert_array_equal(r[0], np.arange(5))
    for idx in (one, hier):
        np.testing.assert_array_equal(idx.search(base, 5)[1], r)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
@pytest.mark.parametrize("tier", ["exact", "fused"])
def test_hierarchical_merge_matches_jax(rng, shape, tier):
    E = _unit(rng, 4000, 64)
    q = _unit(rng, 5, 64)
    jidx, pidx = _pair(64, S=8, slices=shape[0], tier=tier, block_rows=128)
    assert jidx.axis == ("dcn", "ici") and pidx.hierarchical
    _both(lambda i: i.add(E), jidx, pidx)
    r = _same(jidx, pidx, q, 10)
    flat = ShardedIndex(dim=64, mesh=CPU8, tier=tier, block_rows=128)
    flat.add(E)
    np.testing.assert_array_equal(r, flat.search(q, 10)[1])


@pytest.mark.parametrize("tier", ["exact", "bf16", "int8"])
def test_bf16_store_dtype(rng, tier):
    E = _unit(rng, 2048, 64)
    q = _unit(rng, 4, 64)
    jidx, pidx = _pair(64, tier=tier, block_rows=64, store_dtype="bfloat16")
    _both(lambda i: i.add(E), jidx, pidx)
    _same(jidx, pidx, q, 10)
    assert pidx.E[0].dtype == torch.bfloat16


def test_non_pow2_block_rows_scans_all_rows(rng):
    E = _unit(rng, 4096, 64)
    q = _unit(rng, 4, 64)
    jidx, pidx = _pair(64, tier="fused", block_rows=384)
    assert pidx.block_rows == jidx.block_rows == 256
    _both(lambda i: i.add(E), jidx, pidx)
    r = _same(jidx, pidx, q, 10)
    single = DeviceIndex(dim=64, tier="exact", device="cpu")
    single.add(E)
    np.testing.assert_array_equal(r, single.search(q, 10)[1])


# ---------------------------------------------------------------------------
# the write path
def test_append_growth_delete(rng):
    jidx, pidx = _pair(32, capacity=2048, tier="exact", block_rows=256)
    cap0 = pidx.capacity
    q = _unit(rng, 3, 32)
    for n in (100, 57, 900, cap0):
        E = _unit(rng, n, 32)
        assert jidx.add(E) == pidx.add(E)
        _same(jidx, pidx, q, 7)
    assert pidx.capacity == jidx.capacity > cap0 and pidx.count == jidx.count
    _both(lambda i: i.delete_rows(np.array([13, 1000])), jidx, pidx)
    _both(lambda i: i.set_rows(np.array([14]), q[:1]), jidx, pidx)
    r = _same(jidx, pidx, q, 7)
    assert r[0, 0] == 14


def test_empty_and_fewer_rows_than_shards(rng):
    jidx, pidx = _pair(32, tier="int8", block_rows=64)
    q = _unit(rng, 2, 32)
    s, r = pidx.search(q, 5)
    assert (r == -1).all() and np.isneginf(s).all()
    E = _unit(rng, 3, 32)  # shards 3..7 hold no live row
    _both(lambda i: i.add(E), jidx, pidx)
    r = _same(jidx, pidx, q, 5)
    assert (r[:, 3:] == -1).all() and set(r[0, :3]) == {0, 1, 2}


@pytest.mark.parametrize("tier", ["int8", "bf16"])
def test_derived_copies_update_per_batch(rng, tier):
    # writes update the int8 / bf16 copies in place, O(batch): the same
    # tensors after appends, a delete and a rewrite, equal to copies
    # built from scratch over the final rows
    E = _unit(rng, 600, 64)
    q = E[:4]
    jidx, pidx = _pair(64, capacity=8192, tier=tier, block_rows=64)
    _both(lambda i: i.add(E[:500]), jidx, pidx)
    _same(jidx, pidx, q, 5)
    names = ("_E_q", "_scales") if tier == "int8" else ("_E_bf16",)
    before = [[t.data_ptr() for t in getattr(pidx, name)] for name in names]
    for idx in (jidx, pidx):
        idx.add(E[500:])
        idx.delete_rows(np.array([3]))
        idx.set_rows(np.array([7]), E[7:8] * 0.5)
    assert [[t.data_ptr() for t in getattr(pidx, name)] for name in names] == before
    assert jidx.derived_rebuilds == 1  # nor did JAX's rebuild them
    _same(jidx, pidx, q, 5)
    fresh = ShardedIndex(dim=64, mesh=CPU8, capacity=8192, tier=tier, block_rows=64)
    fresh.add(E)
    fresh.delete_rows(np.array([3]))
    fresh.set_rows(np.array([7]), E[7:8] * 0.5)
    fresh.search(q, 5)
    for name in names:
        for a, b in zip(getattr(pidx, name), getattr(fresh, name)):
            assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# deep k
def test_search_deep_past_cap_s(rng):
    E = _unit(rng, 1500, 32)
    q = _unit(rng, 3, 32)
    jidx, pidx = _pair(32, capacity=2048, tier="bf16", block_rows=256,
                       store_dtype="bfloat16")
    _both(lambda i: i.add(E), jidx, pidx)
    assert pidx.cap_s == 256
    jv, jg = jidx.search_deep(q, 1200)
    pv, pg = pidx.search_deep(q, 1200)
    np.testing.assert_array_equal(pg, jg)
    np.testing.assert_allclose(pv, jv, rtol=0, atol=1e-5)
    # past count: padded, never clamped silently
    pv, pg = pidx.search_deep(q, 1600)
    assert pv.shape == (3, 1600) and (pg[:, 1500:] == -1).all()


@pytest.mark.parametrize("tier", ["exact", "int8"])
def test_search_core_deep_k_beyond_cap_s(rng, tier):
    E = _unit(rng, 400, 16)
    q = _unit(rng, 8, 16)
    jidx, pidx = _pair(16, capacity=512, tier=tier, block_rows=32)
    _both(lambda i: i.add(E), jidx, pidx)
    assert pidx.cap_s == 64 and pidx._effective_tier(300) == "deep"
    vals, gids = pidx.search_device(torch.from_numpy(q), 300)
    ref = q @ E.T
    for i in range(8):
        order = np.lexsort((np.arange(400), -ref[i]))[:300]
        np.testing.assert_array_equal(gids[i].numpy(), order)
        np.testing.assert_allclose(vals[i].numpy(), ref[i][order], rtol=0, atol=1e-5)
    _same(jidx, pidx, q, 300)  # search() is not clamped to cap_s


# ---------------------------------------------------------------------------
# snapshots across packages and index kinds
@pytest.mark.parametrize("store", ["float32", "bfloat16"])
def test_snapshots_load_across_packages_and_kinds(rng, tmp_path, store):
    from modular_rag_system_tpu.index import DeviceIndex as JaxIndex
    from modular_rag_system_tpu.parallel.sharded import ShardedIndex as JaxSharded

    E = _unit(rng, 300, 32)
    q = _unit(rng, 2, 32)
    jidx, pidx = _pair(32, tier="exact", block_rows=256, store_dtype=store)
    _both(lambda i: i.add(E), jidx, pidx)
    jidx.snapshot(str(tmp_path / "jax.npz"))
    pidx.snapshot(str(tmp_path / "port.npz"))
    j, p = np.load(str(tmp_path / "jax.npz")), np.load(str(tmp_path / "port.npz"))
    assert sorted(j.files) == sorted(p.files)
    for name in j.files:
        np.testing.assert_array_equal(j[name], p[name], err_msg=name)
    ref = _same(jidx, pidx, q, 5)
    loads = [ShardedIndex.load(str(tmp_path / "jax.npz"), mesh=CPU8),
             ShardedIndex.load(str(tmp_path / "port.npz"), mesh=["cpu"] * 3),
             DeviceIndex.load(str(tmp_path / "port.npz"), device="cpu"),
             JaxSharded.load(str(tmp_path / "port.npz"), mesh=_jax_mesh()),
             JaxIndex.load(str(tmp_path / "port.npz"))]
    for idx in loads:
        assert idx.count == 300 and idx.store_dtype == store
        np.testing.assert_array_equal(idx.search(q, 5)[1], ref)
    # a DeviceIndex snapshot loads as 8 shards
    single = DeviceIndex(dim=32, tier="exact", store_dtype=store, device="cpu")
    single.add(E)
    single.snapshot(str(tmp_path / "single.npz"))
    back = ShardedIndex.load(str(tmp_path / "single.npz"), mesh=CPU8)
    np.testing.assert_array_equal(back.search(q, 5)[1], ref)


def test_load_keeps_every_knob(rng, tmp_path):
    idx = ShardedIndex(dim=32, mesh=CPU8, tier="exact", block_rows=256)
    idx.add(_unit(rng, 60, 32))
    path = str(tmp_path / "knobs.npz")
    idx.snapshot(path)
    knobs = dict(block_rows=128, fused_bin_width=128, ivf_clusters=4, ivf_nprobe=2,
                 ivf_iters=3, ivf_fine_dtype="int8", ivf_tail_frac=0.5, ivf_rebuild_min=7,
                 ivf_refine_extra=5, ivf_balance=1.25)
    back = ShardedIndex.load(path, mesh=CPU8, tier="ivf", **knobs)
    for key, val in knobs.items():
        assert getattr(back, key) == val, key
    assert back.count == 60 and back.tier == "ivf"


# ---------------------------------------------------------------------------
# the ivf tier
def test_kmeans_fit_sharded_matches_jax(rng):
    import jax.numpy as jnp

    from modular_rag_system_tpu.ops import kmeans as jkm

    E = _clustered(rng, 16, 3000, 32)
    idx = ShardedIndex(dim=32, mesh=CPU8, capacity=4096, tier="exact")
    idx.add(E)
    jE = np.stack([e.numpy() for e in idx.E])  # (S, cap_s, d)
    init = jkm.init_centroids_from_rows(E, 3000, 16)
    jc, jl = jkm.kmeans_fit_sharded(jnp.asarray(jE), 3000, init, _jax_mesh(), "index",
                                    iters=6, batch=256)
    pc, pl_ = pkm.kmeans_fit_sharded(idx.E, 3000, init, iters=6, batch=256)
    np.testing.assert_allclose(pc.numpy(), np.asarray(jc), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(np.stack([x.numpy() for x in pl_]), np.asarray(jl))
    # and equal to single-device k-means over the same rows
    sc, sl = pkm.kmeans_fit(torch.from_numpy(E), 3000, init, iters=6, batch=256)
    np.testing.assert_allclose(pc.numpy(), sc.numpy(), rtol=0, atol=1e-5)


def _jax_ivf_state(jidx):
    """A built JAX sharded structure's per-shard arrays as numpy."""
    iv = jidx._ivf2
    return {name: np.asarray(getattr(iv, name)) for name in
            ("E_c", "perm", "inv_perm", "blk_start", "nblk", "counts", "block_cluster")} | (
        {"scales": np.asarray(iv.scales)} if iv.scales is not None else {})


def _assert_same_ivf(jidx, pidx):
    js = _jax_ivf_state(jidx)
    iv = pidx._ivf2
    assert iv.built == jidx._ivf2.built and iv.n_clusters == js["nblk"].shape[1]
    for s, p in enumerate(iv.shards):
        np.testing.assert_array_equal(js["E_c"][s].astype(np.float32), p.E_c3.float().numpy())
        for jname, pname in (("perm", "perm"), ("inv_perm", "inv_perm"),
                             ("blk_start", "blk_start"), ("nblk", "nblk"),
                             ("counts", "counts"), ("block_cluster", "block_cluster")):
            np.testing.assert_array_equal(js[jname][s], getattr(p, pname).numpy(),
                                          err_msg=f"{jname}[{s}]")
        if "scales" in js:
            np.testing.assert_array_equal(js["scales"][s], p.scales3.numpy())


_IVF = dict(block_rows=64, ivf_clusters=16, ivf_nprobe=4, ivf_iters=4, ivf_rebuild_min=64)


@pytest.mark.parametrize("fine", ["bf16", "int8", "int4"])
def test_ivf_warm_start_from_jax_matches(rng, tmp_path, fine):
    # JAX's cold build, snapshotted; both packages restore it (the warm
    # start) and must agree slab for slab and id for id
    from modular_rag_system_tpu.parallel.sharded import ShardedIndex as JaxSharded

    kw = dict(_IVF, tier="ivf", ivf_fine_dtype=fine)
    E = _clustered(rng, 16, 3000, 32)
    jcold = JaxSharded(dim=32, mesh=_jax_mesh(), **kw)
    jcold.add(E)
    path = str(tmp_path / "jax.npz")
    jcold.snapshot(path)
    jidx = JaxSharded.load(path, mesh=_jax_mesh(), **kw)
    pidx = ShardedIndex.load(path, mesh=CPU8, **kw)
    assert pidx._ivf2.warm_started and pidx.ivf_warmstart is None
    _assert_same_ivf(jidx, pidx)
    q = np.concatenate([E[[5, 2100]], _unit(rng, 4, 32)])
    _same(jidx, pidx, q, 10)
    _same(jidx, pidx, q, 100)  # k > 64: exact per shard
    # the tail, deletes, rewrites of built rows
    more = _clustered(rng, 16, 200, 32)
    for idx in (jidx, pidx):
        idx.add(more)
        idx.delete_rows(np.array([5, 3100]))
        idx.set_rows(np.array([6]), more[:1])
    assert pidx._ivf2.stale_rows == jidx._ivf2.stale_rows == 2
    assert pidx.ivf_rebuilds == jidx.ivf_rebuilds == 1
    _same(jidx, pidx, np.concatenate([q, more[:2]]), 10)
    _assert_same_ivf(jidx, pidx)  # the row updates too, nibbles and scales
    # the port's snapshot carries JAX's clustering back
    pidx.snapshot(str(tmp_path / "port.npz"))
    np.testing.assert_array_equal(np.load(str(tmp_path / "port.npz"))["ivf_labels"],
                                  jidx._ivf2.labels_host_global(8))


def test_ivf_cold_build_matches_jax(rng):
    kw = dict(_IVF, tier="ivf", ivf_fine_dtype="bf16", ivf_nprobe=16)
    E = _clustered(rng, 16, 4096, 32)
    jidx, pidx = _pair(32, **kw)
    _both(lambda i: i.add(E), jidx, pidx)
    assert pidx._ivf2 is not None and pidx.ivf_rebuilds == 1
    np.testing.assert_allclose(pidx._ivf2.shards[0].centroids.numpy(),
                               np.asarray(jidx._ivf2.centroids), rtol=0, atol=1e-5)
    # every live row laid out exactly once over the shards
    gids = sorted(int(r) * 8 + s for s, p in enumerate(pidx._ivf2.shards)
                  for r in p.perm.numpy() if r >= 0)
    assert gids == list(range(4096))
    # nprobe = every cluster: recall against exact is 1
    q = E[:16]
    _, got = pidx.search(q, 10)
    exact = DeviceIndex(dim=32, tier="exact", device="cpu")
    exact.add(E)
    np.testing.assert_array_equal(got, exact.search(q, 10)[1])


def test_ivf_hierarchical_layout(rng, tmp_path):
    from modular_rag_system_tpu.parallel.sharded import ShardedIndex as JaxSharded

    kw = dict(_IVF, tier="ivf", ivf_fine_dtype="bf16")
    E = _clustered(rng, 16, 2048, 32)
    flat = JaxSharded(dim=32, mesh=_jax_mesh(), **kw)
    flat.add(E)
    flat.snapshot(str(tmp_path / "s.npz"))
    jidx = JaxSharded.load(str(tmp_path / "s.npz"), mesh=_jax_mesh(8, 2), **kw)
    pidx = ShardedIndex.load(str(tmp_path / "s.npz"), mesh=[["cpu"] * 4] * 2, **kw)
    q = E[:4]
    r = _same(jidx, pidx, q, 5)
    np.testing.assert_array_equal(r[:, 0], np.arange(4))


@pytest.mark.parametrize("fine", ["bf16", "int4"])
def test_ivf_balance_and_int4(rng, fine):
    # the LBG splits on global counts (JAX's test_sharded_ivf_balance) and
    # the int4 nibble scatter (test_sharded_ivf_int4), on 4 shards
    d, N = 32, 4096
    centers = _unit(rng, 16, d)
    w = np.ones(16)
    w[:2] = 12.0
    E = centers[rng.choice(16, N, p=w / w.sum())] + 0.05 * rng.standard_normal((N, d))
    E = _bf16_exact((E / np.linalg.norm(E, axis=1, keepdims=True)).astype(np.float32))
    kw = dict(tier="ivf", block_rows=64, ivf_clusters=8, ivf_nprobe=8 if fine == "int4" else 2,
              ivf_iters=4, ivf_rebuild_min=64, ivf_fine_dtype=fine,
              ivf_balance=1.5 if fine == "bf16" else 0.0)
    jidx, pidx = _pair(d, S=4, **kw)
    _both(lambda i: i.add(E), jidx, pidx)
    assert pidx._ivf2.n_clusters == jidx._ivf2.centroids.shape[0]
    if fine == "bf16":
        assert pidx._ivf2.n_clusters > 8  # splits happened
    np.testing.assert_allclose(pidx._ivf2.shards[0].centroids.numpy(),
                               np.asarray(jidx._ivf2.centroids), rtol=0, atol=1e-5)
    _, got = pidx.search(E[:16], 1)
    np.testing.assert_array_equal(got[:, 0], np.arange(16))
    if fine == "int4":
        assert pidx._ivf2.shards[0].E_c3.shape[1] == pivf.SLAB // 2
        pidx.delete_rows(np.asarray([3]))
        s, got = pidx.search(E[3:4], 1)
        assert got[0, 0] != 3 or s[0, 0] < 0.5
        pidx.set_rows(np.asarray([3]), E[3:4])
        assert pidx.search(E[3:4], 1)[1][0, 0] == 3


def test_ivf_writes_serve_tail_and_rebuild(rng):
    # appends below the threshold go to each shard's exact tail; crossing
    # it rebuilds from the write path; update-only drift rebuilds too
    E = _unit(rng, 1400, 32)
    idx = ShardedIndex(dim=32, mesh=CPU8, tier="ivf", block_rows=64, ivf_clusters=8,
                       ivf_nprobe=8, ivf_iters=4, ivf_rebuild_min=256, ivf_fine_dtype="bf16")
    idx.add(E[:1000])
    assert idx.ivf_rebuilds == 1 and idx._ivf2.built == 1000
    built = idx._ivf2
    idx.add(E[1000:1100])
    # the tail grew: the same build serves, its exact tail finds the new rows
    assert idx._ivf2 is built and built.built == 1000 and built.version == 0
    assert idx.ivf_stats()["tail_rows"] == 100
    np.testing.assert_array_equal(idx.search(E[1020:1022], 5)[1][:, 0], [1020, 1021])
    idx.add(E[1100:])
    assert idx.ivf_rebuilds == 2 and idx._ivf2.built == idx.count
    assert idx._ivf2.version == 1  # the new build's version
    drift = ShardedIndex(dim=32, mesh=CPU8, tier="ivf", block_rows=64, ivf_clusters=8,
                         ivf_nprobe=1, ivf_iters=4, ivf_rebuild_min=64, ivf_tail_frac=0.1,
                         ivf_fine_dtype="bf16")
    drift.add(E[:1024])
    moved = _unit(rng, 384, 32)
    for lo in range(0, 384, 48):
        drift.set_rows(np.arange(lo, lo + 48), moved[lo:lo + 48])
    assert drift.ivf_rebuilds > 1, "update-only drift never rebuilt"
    np.testing.assert_array_equal(drift.search(moved[:8], 1)[1][:, 0], np.arange(8))


def test_auto_tier_promotes_on_global_count(rng, monkeypatch):
    from modular_rag_system_tpu.index import DeviceIndex as JaxIndex

    for cls in (JaxIndex, DeviceIndex):
        monkeypatch.setattr(cls, "_AUTO_IVF_ROWS", 1000)
    E = _unit(rng, 1600, 32)
    q = _unit(rng, 4, 32)
    jidx, pidx = _pair(32, tier="auto", block_rows=256, ivf_clusters=8, ivf_nprobe=8,
                       ivf_rebuild_min=64)
    _both(lambda i: i.add(E[:900]), jidx, pidx)
    assert pidx.effective_tier() == "int8" and pidx._ivf2 is None
    _same(jidx, pidx, q, 10)
    _both(lambda i: i.add(E[900:]), jidx, pidx)  # 200 rows a shard: the global count
    assert pidx.effective_tier() == "ivf" and pidx._ivf2 is not None
    assert pidx._effective_tier(10) == "ivf" and pidx._ivf2.fine_dtype == "bf16"
    r = _same(jidx, pidx, q, 10)
    exact = DeviceIndex(dim=32, tier="exact", device="cpu")
    exact.add(E)
    np.testing.assert_array_equal(r, exact.search(q, 10)[1])


def test_ivf_before_first_build_serves_exact(rng):
    kw = dict(tier="ivf", block_rows=64, ivf_rebuild_min=32768)
    E = _unit(rng, 700, 32)
    jidx, pidx = _pair(32, **kw)
    _both(lambda i: i.add(E), jidx, pidx)
    assert pidx._ivf2 is None and pidx._effective_tier(10) == "exact"
    _same(jidx, pidx, _unit(rng, 3, 32), 10)


def test_queries_serve_during_rebuild(rng, monkeypatch):
    # the k-means + fill run under the write gate, outside the state
    # lock: searches serve the old structure + exact tail meanwhile, and
    # a second writer waits for the build
    idx = ShardedIndex(dim=32, mesh=["cpu"] * 4, tier="ivf", block_rows=64, ivf_clusters=8,
                       ivf_nprobe=8, ivf_iters=3, ivf_rebuild_min=64, ivf_fine_dtype="bf16")
    E = _unit(rng, 400, 32)
    idx.add(E)
    assert idx.ivf_rebuilds == 1
    started, release = threading.Event(), threading.Event()
    orig = pkm.kmeans_fit_sharded

    def slow(*a, **kw):
        started.set()
        assert release.wait(30)
        return orig(*a, **kw)

    monkeypatch.setattr(pkm, "kmeans_fit_sharded", slow)
    fresh = _unit(rng, 400, 32)
    writer = threading.Thread(target=idx.add, args=(fresh,), daemon=True)
    writer.start()
    assert started.wait(30)
    got = {}
    reader = threading.Thread(target=lambda: got.update(r=idx.search(E[:2], 3)), daemon=True)
    reader.start()
    reader.join(30)
    assert not reader.is_alive(), "search blocked behind a rebuild"
    np.testing.assert_array_equal(got["r"][1][:, 0], [0, 1])
    done = threading.Event()
    w2 = threading.Thread(target=lambda: (idx.delete_rows(np.asarray([5])), done.set()),
                          daemon=True)
    w2.start()
    assert not done.wait(0.5), "a writer ran during the rebuild"
    release.set()
    writer.join(60)
    w2.join(60)
    assert done.is_set() and idx.ivf_rebuilds == 2 and idx._ivf2.built == idx.count
    assert idx.search(fresh[:1], 1)[1][0, 0] == 400


def test_shards_own_their_tensors(rng):
    # several shards on one device: no derived buffer is shared
    idx = ShardedIndex(dim=32, mesh=["cpu"] * 4, tier="ivf", block_rows=64, ivf_clusters=4,
                       ivf_rebuild_min=64, ivf_fine_dtype="int8")
    idx.add(_unit(rng, 600, 32))
    q = torch.from_numpy(_unit(rng, 2, 32))
    idx.search_device(q, 100)
    idx.tier = "int8"
    idx.search_device(q, 10)
    for group in (idx.E, idx._E_q, idx._scales, [p.E_c3 for p in idx._ivf2.shards],
                  [p.centroids for p in idx._ivf2.shards], [p.perm for p in idx._ivf2.shards]):
        ptrs = [t.data_ptr() for t in group]
        assert len(set(ptrs)) == len(ptrs)


# ---------------------------------------------------------------------------
# on the card: the three tiers of the smoke on ["cuda:0"] * 4, against the
# port's own CPU result (kernels against plain versions: ids equal except
# at near-ties, which unit-scale random rows do not produce here, scores
# within 1e-5)
@pytest.fixture()
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from modular_rag_system_tpu_torch.utils.device import resolve_device

    return resolve_device("cuda")


def _card_and_cpu(cuda_device, E, **kw):
    card = ShardedIndex(dim=E.shape[1], mesh=[cuda_device] * 4, **kw)
    cpu = ShardedIndex(dim=E.shape[1], mesh=["cpu"] * 4, **kw)
    card.add(E)
    cpu.add(E)
    return card, cpu


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["int8-single", "int8-two-pass", "ivf"])
def test_sharded_tiers_on_the_card(cuda_device, case):
    from modular_rag_system_tpu_torch import kernels

    rng = np.random.default_rng(4)
    n, kw, expect = {
        "int8-single": (3000, dict(tier="auto"), "fused_topk_int8"),
        "int8-two-pass": (40000, dict(tier="int8", capacity=65536), "binmax_int8"),
        "ivf": (20000, dict(tier="ivf", ivf_clusters=32, ivf_nprobe=8, ivf_rebuild_min=64,
                            ivf_fine_dtype="int8"), "fine_scores"),
    }[case]
    E = _unit(rng, n, 768) if case != "ivf" else _clustered(rng, 32, n, 768, 0.3)
    card, cpu = _card_and_cpu(cuda_device, E, **kw)
    if case == "ivf":  # the same clustering on both: the CPU's, as a warm start
        card.ivf_warmstart = (cpu._ivf2.shards[0].centroids.numpy(),
                              cpu._ivf2.labels_host_global(4))
        card.build_ann()
    q = np.concatenate([E[:8], _unit(rng, 8, 768)])
    kernels.reset_launches()
    cv, cr = card.search(q, 10)
    assert kernels.launches[expect] == 4  # once per shard
    pv, pr = cpu.search(q, 10)
    np.testing.assert_array_equal(cr, pr)
    np.testing.assert_allclose(cv, pv, rtol=0, atol=1e-5)
