#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``modular_rag_system_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. kernels: builds every CUDA kernel from ``modular_rag_system_tpu_torch/
   kernels/*.cu`` (one ``nvcc`` per source, in parallel), holds each
   kernel against its plain PyTorch version on seeded inputs at d=768
   (crafted ties, a count that is no multiple of the bin width, count < k)
   and times both with CUDA events (20 back-to-back calls), beside one PyTorch
   library call that computes the same function and the card's bound;
3. engine: ``create_engine`` with the bundled hybrid encoder (dim 768),
   ``index.tier="auto"``: ingests the bundled knowledge sentences and QA
   passages as text (single-pass ``fused_topk_int8`` route), queries,
   then fills the index with seeded unit-norm rows to 1,048,576 rows
   (two-pass ``binmax_int8`` route) and queries again, holding the ids
   against the exact tier; kernel launch counts are read around each
   route;
4. restart: shutdown (snapshot), a new engine from the snapshot, a query.

The last three lines are the ``nvidia-smi`` line, the kernels JSON line
and the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
D = 768
FULL_ROWS = 1_048_576
FILL_BATCH = 65_536

# published dense peaks of the card variants nvidia-smi may name:
# (HBM bytes/s, int8 ops/s, bf16 ops/s)
_SPECS = {
    "H100 PCIe": (2.0e12, 1513e12, 756e12),
    "H100 NVL": (3.9e12, 1671e12, 835e12),
    "H100": (3.35e12, 1979e12, 989e12),  # SXM5 (nvidia-smi: "H100 80GB HBM3")
}


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def spec_for(name: str):
    for key, spec in _SPECS.items():
        if key in name:
            return key, spec
    raise RuntimeError(f"no published spec for {name!r}")


def cuda_ms(fn, reps: int = 20) -> float:
    """Device time per call: CUDA events around ``reps`` back-to-back
    calls (after a warm-up call), so the host's launch work overlaps the
    device's execution instead of adding to it."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """The kernel's own device time per launch, from ``torch.profiler``
    (CUPTI): no host launch work in it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [ev for ev in prof.key_averages() if kernel in ev.key]
    if not hits:
        raise AssertionError(f"the profiler saw no {kernel} kernel")
    return sum(ev.device_time_total for ev in hits) / reps / 1e3


def wall_ms(fn, reps: int = 10) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
def quantized_rows(g, cap, count, dev):
    """int8 rows + scales of seeded unit vectors; rows past count are 0."""
    import torch

    from modular_rag_system_tpu_torch.ops.quantize import quantize_rows

    E_q = torch.zeros((cap, D), dtype=torch.int8, device=dev)
    scales = torch.zeros((cap, 1), dtype=torch.float32, device=dev)
    for s in range(0, count, FILL_BATCH):
        n = min(FILL_BATCH, count - s)
        x = torch.randn((n, D), generator=g, device=dev)
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        E_q[s:s + n], scales[s:s + n] = quantize_rows(x)
    return E_q, scales.reshape(cap)


def unit_queries(g, Q, dev):
    import torch

    q = torch.randn((Q, D), generator=g, device=dev)
    return q / torch.linalg.vector_norm(q, dim=1, keepdim=True)


def bound(nbytes: int, ops: int, peak_ops: float, spec):
    t_bytes, t_ops = nbytes / spec[0] * 1e3, ops / peak_ops * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_binmax(g, dev):
    """binmax_int8 vs its plain version, bit for bit."""
    import torch

    from modular_rag_system_tpu_torch.ops import binmax_topk as B

    for cap in (8192, FULL_ROWS):
        count = cap - 13  # not a multiple of the bin width
        E_q, sc = quantized_rows(g, cap, count, dev)
        for Q in (1, 16, 256):
            q_i8, q_scale = B.quantize_queries(unit_queries(g, Q, dev))
            args = (E_q, sc, q_i8, q_scale, 32)
            out = B.binmax_int8_call(*args)
            ref = B.binmax_int8_reference(*args)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                raise AssertionError(f"binmax_int8 differs from its plain version at "
                                     f"cap={cap} Q={Q}: max |d| "
                                     f"{(out - ref).abs().max().item()}")
        log(f"kernel binmax_int8 cap={cap} count={count} Q=1,16,256: bit-exact")
        del E_q, sc
        torch.cuda.empty_cache()
    return 0.0


def time_binmax(eng, q, spec):
    """binmax_int8 at the two-pass route's inputs: the engine's int8 rows
    and quantized query embeddings."""
    import torch

    from modular_rag_system_tpu_torch.ops import binmax_topk as B

    E_q, sc, _ = eng.index.search_ops()
    sc = sc.reshape(-1)
    cap, bw = E_q.shape[0], B.auto_bin_width(E_q.shape[0])
    nb = cap // bw
    res = {}
    for Q in (q.shape[0], 1):
        q_i8, q_scale = B.quantize_queries(q[:Q])
        args = (E_q, sc, q_i8, q_scale, bw)
        ms = cuda_ms(lambda: B.binmax_int8_call(*args))
        dev_ms = device_ms(lambda: B.binmax_int8_call(*args), "binmax_int8_kernel")
        plain = cuda_ms(lambda: B.binmax_int8_reference(*args), reps=5)
        lib = None
        if Q % 8 == 0:
            # one library int8 GEMM (int8 x int8 -> int32) + the epilogue
            qt = q_i8.T  # (d, Q), column-major

            def library():
                acc = torch._int_mm(E_q, qt)
                s = acc.float() * sc[:, None] * q_scale[None, :]
                return s.view(nb, bw, Q).amax(1).T

            lib = cuda_ms(library)
        b_ms, b_by = bound(cap * D + cap * 4 + Q * D + Q * 4 + Q * nb * 4,
                           2 * cap * Q * D, spec[1], spec)
        log(f"time binmax_int8 cap={cap} Q={Q}: {ms:.4f} ms (device {dev_ms:.4f} ms; "
            f"plain {plain:.4f} ms, "
            f"library {None if lib is None else round(lib, 4)} ms, bound {b_ms:.4f} ms "
            f"by {b_by})")
        res[Q] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                  "bound_by": b_by}
    return res[q.shape[0]]


def _check_fused_result(v1, i1, v2, i2, E_q, sc, q, exact_ties, what):
    """Scores within 1e-5 (f32 summation order); ids equal except where
    the kernel picked a near-tie, verified against an f64 rescore."""
    import torch

    fin = torch.isfinite(v2)
    if not torch.equal(torch.isfinite(v1), fin):
        raise AssertionError(f"fused_topk_int8 {what}: -inf slots differ")
    err = (v1[fin] - v2[fin]).abs().max().item() if fin.any() else 0.0
    if exact_ties:
        if not (torch.equal(v1[fin], v2[fin]) and torch.equal(i1[fin], i2[fin])):
            raise AssertionError(f"fused_topk_int8 {what}: exact-sum ties differ")
        return err
    if not torch.allclose(v1[fin], v2[fin], rtol=1e-5, atol=1e-5):
        raise AssertionError(f"fused_topk_int8 {what}: scores differ by {err}")
    bad = (i1 != i2) & fin
    if bad.any():
        qi = bad.nonzero()[:, 0]
        rows = i1[bad].long()
        qb = q.to(torch.bfloat16).double()[qi]
        exact = (qb * E_q[rows].double()).sum(1) * sc[rows].double()
        gap = (exact - v2[bad].double()).abs().max().item()
        if gap > 2e-5:
            raise AssertionError(f"fused_topk_int8 {what}: {int(bad.sum())} ids "
                                 f"differ beyond near-ties (gap {gap})")
        log(f"  {what}: {int(bad.sum())} of {int(fin.sum())} ids are near-tie swaps "
            f"(gap {gap:.2e})")
    return err


def check_fused(g, dev):
    import torch

    from modular_rag_system_tpu_torch.ops import fused_topk as F

    worst = 0.0
    Q = 16
    for cap, count in ((1024, 1000), (4096, 4001), (32768, 32700)):
        E_q, sc = quantized_rows(g, cap, count, dev)
        q = unit_queries(g, Q, dev)
        for k in (1, 10, 20, 1024, 2048):
            if k > cap:
                continue
            for bw in (None, 128):
                args = (E_q, sc, count, q, k, bw)
                v1, i1 = F.fused_topk_int8_raw(*args)
                v2, i2 = F.fused_topk_int8_reference(*args)
                torch.cuda.synchronize()
                worst = max(worst, _check_fused_result(
                    v1, i1, v2, i2, E_q, sc, q, False, f"cap={cap} k={k} bw={bw}"))
        log(f"kernel fused_topk_int8 cap={cap} count={count}: k 1..2048 match "
            f"(max |err| so far {worst:.2e})")
    # count < k, and crafted ties: small-integer rows, unit scales,
    # integer queries -> every sum is exact and ties decide the order
    E_q, sc = quantized_rows(g, 1024, 5, dev)
    q = unit_queries(g, Q, dev)
    v1, i1 = F.fused_topk_int8_raw(E_q, sc, 5, q, 10)
    v2, i2 = F.fused_topk_int8_reference(E_q, sc, 5, q, 10)
    _check_fused_result(v1, i1, v2, i2, E_q, sc, q, False, "count<k")
    if int(torch.isfinite(v1).sum(1).max()) != 5:
        raise AssertionError("fused_topk_int8 count<k: wrong number of live slots")
    E_t = torch.randint(-2, 3, (4096, D), generator=g, device=dev).to(torch.int8)
    sc_t = torch.ones(4096, device=dev)
    q_t = torch.randint(-1, 2, (Q, D), generator=g, device=dev).float()
    for k, bw in ((16, None), (1024, None), (8, 128)):
        v1, i1 = F.fused_topk_int8_raw(E_t, sc_t, 3000, q_t, k, bw)
        v2, i2 = F.fused_topk_int8_reference(E_t, sc_t, 3000, q_t, k, bw)
        _check_fused_result(v1, i1, v2, i2, E_t, sc_t, q_t, True, f"ties k={k} bw={bw}")
    log("kernel fused_topk_int8 crafted ties and count<k: exact match")

    return worst


def time_fused(eng, q, spec):
    """fused_topk_int8 at the single-pass route's inputs: the engine's
    int8 rows and query embeddings, kf = int8_refine_kf(10, capacity)."""
    import torch

    from modular_rag_system_tpu_torch.ops import fused_topk as F
    from modular_rag_system_tpu_torch.ops.binmax_topk import int8_refine_kf

    E_q, sc, _ = eng.index.search_ops()
    sc = sc.reshape(-1)
    count, cap = eng.index.count, E_q.shape[0]
    kf = int8_refine_kf(10, cap)
    E_bf = E_q[:count].to(torch.bfloat16)
    res = {}
    for Q in (q.shape[0], 1):
        qq = q[:Q]
        ms = cuda_ms(lambda: F.fused_topk_int8_raw(E_q, sc, count, qq, kf))
        dev_ms = device_ms(lambda: F.fused_topk_int8_raw(E_q, sc, count, qq, kf),
                           "fused_topk_int8_kernel")
        plain = cuda_ms(lambda: F.fused_topk_int8_reference(E_q, sc, count, qq, kf))

        def library():
            s = (qq.to(torch.bfloat16) @ E_bf.T).float() * sc[:count]
            return torch.topk(s, kf, dim=1)

        lib = cuda_ms(library)
        b_ms, b_by = bound(count * D + count * 4 + Q * D * 2 + Q * kf * 8,
                           2 * Q * count * D, spec[2], spec)
        log(f"time fused_topk_int8 cap={cap} count={count} Q={Q} k={kf}: {ms:.4f} ms "
            f"(device {dev_ms:.4f} ms; plain {plain:.4f} ms, library {lib:.4f} ms, bound {b_ms:.4f} ms by {b_by})")
        res[Q] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                  "bound_by": b_by}
    return res[q.shape[0]]


# ---------------------------------------------------------------------------
# phase 3: the engine
def load_corpus():
    train = ROOT / "modular_rag_system_tpu" / "assets" / "train"
    know = json.loads((train / "knowledge.json").read_text())["sentences"]
    items = json.loads((train / "qa_pairs.json").read_text())["items"]
    return know, [it["query"] for it in items], [it["passage"] for it in items]


def gold_recall(eng, questions, passages, k=10):
    res = eng.query_batch(questions, max_results=k, similarity_threshold=0.0)
    hits = sum(any(d.content.strip() == p.strip() for d in r.documents)
               for r, p in zip(res, passages))
    return hits / len(questions)


def query_timings(eng, questions):
    lat = []
    for t in questions[:20]:
        t0 = time.perf_counter()
        eng.query(t, similarity_threshold=0.0)
        lat.append((time.perf_counter() - t0) * 1e3)
    batch = questions[:256]
    t_b = wall_ms(lambda: eng.query_batch(batch, similarity_threshold=0.0), reps=5)
    return statistics.median(lat[1:]), len(batch) / (t_b / 1e3)


def query_breakdown(eng, questions, route):
    """Wall time of each stage of one query call at Q=1 and Q=256 (each
    stage synchronized), and the device's busy share over one
    ``query_batch`` from ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    dense, lex = eng.encoder.dense, eng.encoder.lexical
    for Q in (1, 256):
        texts = questions[:Q]
        stages = {
            "tokenize": lambda: dense._crop_seq(*dense.tokenizer.encode_batch(texts)),
            "lexical": lambda: lex.encode(texts),
            "embed (tokenize+lexical+forward)": lambda: eng.embed_queries(texts),
        }
        q = eng.embed_queries(texts)
        k = eng._initial_k(eng.config.retrieval.max_results, False)
        stages["search"] = lambda: eng.index.search_core(k)(
            eng.index.search_ops(), eng.index.count, q)
        stages["whole query_batch"] = lambda: eng.query_batch(texts, similarity_threshold=0.0)
        parts = ", ".join(f"{name} {wall_ms(fn, reps=5):.2f} ms" for name, fn in stages.items())
        log(f"{route} Q={Q} stages: {parts}")
    batch = questions[:256]
    eng.query_batch(batch, similarity_threshold=0.0)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.query_batch(batch, similarity_threshold=0.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = sum(ev.self_device_time_total for ev in prof.key_averages()) / 1e3
    log(f"{route} Q=256 query_batch under the profiler: wall {wall:.2f} ms, device "
        f"kernels {busy:.2f} ms, device idle share {1 - busy / wall:.3f}")


def run_route(eng, kernels, questions, name, expect):
    kernels.reset_launches()
    eng.query_batch(questions[:256], similarity_threshold=0.0)
    eng.query(questions[0], similarity_threshold=0.0)
    counts = dict(kernels.launches)
    log(f"route {name}: launches {counts}")
    if counts[expect] == 0:
        raise AssertionError(f"route {name} launched no {expect} kernel")
    return counts[expect]


def check_against_exact(eng, questions):
    import torch

    from modular_rag_system_tpu_torch.ops.exact import exact_topk_raw

    q = eng.embed_queries(questions[:256])
    idx = eng.index
    with idx._lock:
        vals, rows = idx.search_core(10)(idx.search_ops(), idx.count, q)
        ev, er = exact_topk_raw(idx.E, idx.count, q, 10)
        # the returned rows' exact f32 scores
        got = torch.bmm(idx.E[rows.long()].float(), q.unsqueeze(2)).squeeze(2)
    recall = sum(len(set(a) & set(b)) for a, b in
                 zip(rows.tolist(), er.tolist())) / er.numel()
    err = (got - vals).abs().max().item()
    if err > 1e-5:
        raise AssertionError(f"two-pass scores differ from exact scores by {err}")
    return recall, err


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "modular_rag_system_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from modular_rag_system_tpu_torch import RAGConfig, create_engine, kernels
    from modular_rag_system_tpu_torch.types import Document
    from modular_rag_system_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    spec_name, spec = spec_for(name)
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"bound from the published {spec_name} spec {spec}")
    dev = resolve_device("cuda")

    t0 = time.perf_counter()
    kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for kname, blog in kernels.build_logs.items():
        for line in blog.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {kname}: {line.strip()}")

    know, questions, passages = load_corpus()
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"binmax_int8": check_binmax(g, dev), "fused_topk_int8": check_fused(g, dev)}
    torch.cuda.empty_cache()
    entries = {}

    storage = tempfile.mkdtemp(prefix="chip_smoke_")
    cfg = RAGConfig.load(overrides={"index.tier": "auto", "store.storage_path": storage})
    eng = create_engine(cfg)
    log(f"engine: {eng.encoder.name}, dim {eng.index.dim}, device {eng.device}")
    if eng.index.dim != D:
        raise AssertionError(f"expected the 768-wide hybrid index, got {eng.index.dim}")
    t0 = time.perf_counter()
    eng.add_documents([Document(content=t, source="knowledge") for t in know])
    for p in passages:
        eng.add_text(p, source="qa")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_text = eng.index.count
    log(f"ingest text: {n_text} rows in {dt:.2f} s ({n_text / dt:.1f} rows/s), "
        f"capacity {eng.index.capacity}")
    launches = {"fused_topk_int8": run_route(eng, kernels, questions, "single-pass",
                                             "fused_topk_int8")}
    entries["fused_topk_int8"] = time_fused(eng, eng.embed_queries(questions[:256]), spec)
    r_small = gold_recall(eng, questions, passages)
    lat1, qps = query_timings(eng, questions)
    query_breakdown(eng, questions, "single-pass route")
    log(f"single-pass route: gold recall@10 {r_small:.4f}, Q=1 latency {lat1:.2f} ms, "
        f"Q=256 {qps:.1f} QPS")
    if not r_small > 0.3:
        raise AssertionError(f"gold recall@10 {r_small} is implausibly low")

    # fill to FULL_ROWS with seeded unit-norm rows (pre-embedded documents);
    # the first batch tops the count up to a multiple of FILL_BATCH so the
    # pow-2 padded appends keep the capacity at FULL_ROWS
    host_g = torch.Generator().manual_seed(1)
    t0 = time.perf_counter()
    filled = 0
    while eng.index.count < FULL_ROWS:
        n = FILL_BATCH - eng.index.count % FILL_BATCH
        x = torch.randn((n, D), generator=host_g)
        x = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).numpy()
        eng.add_documents([Document(content=f"filler row {filled + i}", source="filler",
                                    embedding=x[i]) for i in range(n)])
        filled += n
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"ingest filler: {filled} rows in {dt:.1f} s ({filled / dt:.0f} rows/s); "
        f"count {eng.index.count}, capacity {eng.index.capacity}")
    if eng.index.capacity != FULL_ROWS:
        raise AssertionError(f"capacity {eng.index.capacity} != {FULL_ROWS}")
    launches["binmax_int8"] = run_route(eng, kernels, questions, "two-pass", "binmax_int8")
    entries["binmax_int8"] = time_binmax(eng, eng.embed_queries(questions[:256]), spec)
    recall, err = check_against_exact(eng, questions)
    log(f"two-pass route vs exact tier: recall@10 {recall:.4f}, "
        f"returned scores within {err:.2e} of exact")
    r_full = gold_recall(eng, questions, passages)
    lat1, qps = query_timings(eng, questions)
    query_breakdown(eng, questions, "two-pass route")
    log(f"two-pass route at {eng.index.count} rows: gold recall@10 {r_full:.4f}, "
        f"Q=1 latency {lat1:.2f} ms, Q=256 {qps:.1f} QPS")
    if r_full < r_small - 0.05:
        raise AssertionError(f"gold recall fell from {r_small} to {r_full}")

    before = eng.query(questions[0], similarity_threshold=0.0)
    t0 = time.perf_counter()
    eng.shutdown()
    eng2 = create_engine(cfg)
    after = eng2.query(questions[0], similarity_threshold=0.0)
    log(f"restart from snapshot: {time.perf_counter() - t0:.1f} s, "
        f"count {eng2.index.count}")
    if [d.id for d in before.documents] != [d.id for d in after.documents]:
        raise AssertionError("results changed across the restart")
    eng2.shutdown()

    out = []
    replaces = {"binmax_int8": "modular_rag_system_tpu/ops/binmax_topk.py:450",
                "fused_topk_int8": "modular_rag_system_tpu/ops/fused_topk.py:282"}
    for kname in kernels.SOURCES:
        out.append({"name": kname, "route": "cuda",
                    "source": f"modular_rag_system_tpu_torch/kernels/{kname}.cu",
                    "replaces": replaces[kname], "launches": launches[kname],
                    "max_abs_err": errs[kname], **entries[kname]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
