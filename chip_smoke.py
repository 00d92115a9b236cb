#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``modular_rag_system_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. kernels: builds every CUDA kernel from ``modular_rag_system_tpu_torch/
   kernels/*.cu`` (one ``nvcc`` per source, in parallel) and holds each
   of the six against its plain PyTorch version on seeded inputs at d=768
   (crafted ties and integer-valued inputs that make the sums exact, a
   count that is no multiple of the bin width, count < k, dead and
   partial fine-stage slots);
3. engine: ``create_engine`` with the bundled hybrid encoder (dim 768),
   ``index.tier="auto"``: ingests the bundled knowledge sentences and QA
   passages as text (single-pass ``fused_topk_int8`` route), queries,
   then fills the index with seeded unit-norm rows to 1,048,576 rows
   (two-pass ``binmax_int8`` route) and queries again, holding the ids
   against the exact tier; restart from the snapshot; then a second
   engine with ``index.tier="ivf"`` over the bundled corpus (below the
   build threshold: the single-pass ``fused_topk`` route);
4. ivf: the restarted engine fills on to 4,718,592 rows (the write path
   promotes ``auto`` to ivf at 4,194,304 rows with a bf16 fine copy and
   an exact tail; ``fine_scores`` route), a k = 100 query batch (the
   ``binmax`` two-pass fallback), one batch at nprobe 512 (the selecting
   ``fine_topk`` kernel), then on to 5,636,096 rows (the rebuild with an
   int8 fine copy), each held against the exact tier; kernel times at
   the engine's own inputs; shutdown (a 17.3 GB snapshot) and a restart
   whose rebuild takes the saved clustering (no k-means).

Each kernel is also held against its plain version at the inputs the
main path gives it (the engine's own rows, queries and probe lists), and
timed there with CUDA events (back-to-back calls, and one call queued
behind a device sleep), beside its plain version, one PyTorch library
call that computes the same function where there is one, and the card's
bound.  Kernel launch counts are set to 0 just before each route is
driven and read just after.  The last three lines are the ``nvidia-smi`` line, the
kernels JSON line and the result line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
D = 768
FULL_ROWS = 1_048_576
IVF_ROWS = 4_718_592      # past the auto promotion at 4,194,304 rows
REBUILD_ROWS = 5_636_096  # the tail passes 25%: the int8 rebuild
FILL_BATCH = 65_536
# the device kernel each launch of a port kernel runs (fine_topk's merge
# is its second kernel and not counted)
_PORT_KERNELS = ("binmax_int8_kernel", "fused_topk_int8_kernel", "binmax_kernel",
                 "fused_topk_kernel", "fine_scores_kernel", "fine_topk_kernel")

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


def queued_ms(fn, reps: int = 20) -> float:
    """Device time of one call with no host time in it: CUDA events
    around the call, queued behind a device-side sleep so the call's
    launches are all enqueued before the first event runs; the median of
    ``reps``.  It includes the wrapper's small kernels (the bf16 cast of
    the queries)."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(1_000_000)  # ~0.5 ms of device time
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


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


def _check_dense(out, ref, exact, what):
    """Kernel scores vs plain scores: the -inf pattern equal and the
    finite values within 1e-5 (f32 summation order), or equal where every
    sum is exact.  Returns the max |error|."""
    import torch

    fin = torch.isfinite(ref)
    if not torch.equal(torch.isfinite(out), fin):
        raise AssertionError(f"{what}: -inf pattern differs")
    err = (out[fin] - ref[fin]).abs().max().item() if fin.any() else 0.0
    if (exact and not torch.equal(out[fin], ref[fin])) or err > 1e-5:
        raise AssertionError(f"{what}: differs from its plain version, max |d| {err}")
    return err


def int8_rescorer(E_q, sc, q):
    """(query rows, ids) -> f64 scores of bf16(q) . int8 row x its scale."""
    import torch

    qb = q.to(torch.bfloat16).double()
    return lambda qi, rows: (qb[qi] * E_q[rows].double()).sum(1) * sc[rows].double()


def float_rescorer(E, q):
    """(query rows, ids) -> f64 scores of bf16(q) . bf16(row)."""
    import torch

    qb = q.to(torch.bfloat16).double()
    return lambda qi, rows: (qb[qi] * E[rows].to(torch.bfloat16).double()).sum(1)


def fine_rescorer(E_c3, sc3, q):
    """(query rows, slots) -> f64 scores of bf16(q) . fine row (x scale)."""
    import torch

    qb = q.to(torch.bfloat16).double()

    def rescore(qi, slots):
        r = (qb[qi] * E_c3.reshape(-1, D)[slots].double()).sum(1)
        return r if sc3 is None else r * sc3.reshape(-1)[slots].double()

    return rescore


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
            _check_dense(B.binmax_int8_call(*args), B.binmax_int8_reference(*args), True,
                         f"binmax_int8 cap={cap} Q={Q}")
        log(f"kernel binmax_int8 cap={cap} count={count} Q=1,16,256: bit-exact")
        del E_q, sc
        torch.cuda.empty_cache()
    return 0.0


def time_binmax(eng, q, spec):
    """binmax_int8 at the two-pass route's inputs (the engine's int8 rows
    and quantized query embeddings): held against its plain version bit
    for bit, then timed.  Returns the timings at Q=len(q) and the max
    |error|."""
    import torch

    from modular_rag_system_tpu_torch.ops import binmax_topk as B

    E_q, sc, _ = eng.index.search_ops()
    sc = sc.reshape(-1)
    cap, bw = E_q.shape[0], B.auto_bin_width(E_q.shape[0])
    nb = cap // bw
    res, worst = {}, 0.0
    for Q in (q.shape[0], 1):
        q_i8, q_scale = B.quantize_queries(q[:Q])
        args = (E_q, sc, q_i8, q_scale, bw)
        worst = max(worst, _check_dense(
            B.binmax_int8_call(*args), B.binmax_int8_reference(*args), True,
            f"binmax_int8 at the two-pass route's inputs, Q={Q}"))
        ms = cuda_ms(lambda: B.binmax_int8_call(*args))
        queued = queued_ms(lambda: B.binmax_int8_call(*args))
        plain = cuda_ms(lambda: B.binmax_int8_reference(*args), reps=5)
        # one library int8 GEMM (int8 x int8 -> int32) + the epilogue;
        # torch._int_mm needs a multiple of 8 queries: pad with zero rows
        Qp = -(-Q // 8) * 8
        qt = torch.nn.functional.pad(q_i8, (0, 0, 0, Qp - Q)).T  # (d, Qp), column-major

        def library():
            acc = torch._int_mm(E_q, qt)[:, :Q]
            s = acc.float() * sc[:, None] * q_scale[None, :]
            return s.view(nb, bw, Q).amax(1).T

        lib = cuda_ms(library)
        b_ms, b_by = bound(cap * D + cap * 4 + Q * D + Q * 4 + Q * nb * 4,
                           2 * cap * Q * D, spec[1], spec)
        log(f"time binmax_int8 cap={cap} Q={Q}: {ms:.4f} ms (queued {queued:.4f} ms; "
            f"plain {plain:.4f} ms, library {lib:.4f} ms (Q padded to {Qp}), "
            f"bound {b_ms:.4f} ms by {b_by}); bit-exact against its plain version")
        res[Q] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                  "bound_by": b_by}
    return res[q.shape[0]], worst


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
                worst = max(worst, _check_topk(v1, i1, v2, i2, int8_rescorer(E_q, sc, q), False,
                                               f"fused_topk_int8 cap={cap} k={k} bw={bw}"))
        log(f"kernel fused_topk_int8 cap={cap} count={count}: k 1..2048 match "
            f"(max |err| so far {worst:.2e})")
    # count < k, and crafted ties: small-integer rows, unit scales,
    # integer queries -> every sum is exact and ties decide the order
    E_q, sc = quantized_rows(g, 1024, 5, dev)
    q = unit_queries(g, Q, dev)
    v1, i1 = F.fused_topk_int8_raw(E_q, sc, 5, q, 10)
    v2, i2 = F.fused_topk_int8_reference(E_q, sc, 5, q, 10)
    _check_topk(v1, i1, v2, i2, int8_rescorer(E_q, sc, q), False, "fused_topk_int8 count<k")
    if int(torch.isfinite(v1).sum(1).max()) != 5:
        raise AssertionError("fused_topk_int8 count<k: wrong number of live slots")
    E_t = torch.randint(-2, 3, (4096, D), generator=g, device=dev).to(torch.int8)
    sc_t = torch.ones(4096, device=dev)
    q_t = torch.randint(-1, 2, (Q, D), generator=g, device=dev).float()
    for k, bw in ((16, None), (1024, None), (8, 128)):
        v1, i1 = F.fused_topk_int8_raw(E_t, sc_t, 3000, q_t, k, bw)
        v2, i2 = F.fused_topk_int8_reference(E_t, sc_t, 3000, q_t, k, bw)
        _check_topk(v1, i1, v2, i2, None, True, f"fused_topk_int8 ties k={k} bw={bw}")
    log("kernel fused_topk_int8 crafted ties and count<k: exact match")
    return worst


def time_fused(eng, q, spec):
    """fused_topk_int8 at the single-pass route's inputs (the engine's
    int8 rows and query embeddings, kf = int8_refine_kf(10, capacity)):
    held against its plain version, then timed.  Returns the timings at
    Q=len(q) and the max |error|."""
    import torch

    from modular_rag_system_tpu_torch.ops import fused_topk as F
    from modular_rag_system_tpu_torch.ops.binmax_topk import int8_refine_kf

    E_q, sc, _ = eng.index.search_ops()
    sc = sc.reshape(-1)
    count, cap = eng.index.count, E_q.shape[0]
    kf = int8_refine_kf(10, cap)
    E_bf = E_q[:count].to(torch.bfloat16)
    res, worst = {}, 0.0
    for Q in (q.shape[0], 1):
        qq = q[:Q]
        v1, i1 = F.fused_topk_int8_raw(E_q, sc, count, qq, kf)
        v2, i2 = F.fused_topk_int8_reference(E_q, sc, count, qq, kf)
        err = _check_topk(v1, i1, v2, i2, int8_rescorer(E_q, sc, qq), False,
                          f"fused_topk_int8 at the single-pass route's inputs, Q={Q}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: F.fused_topk_int8_raw(E_q, sc, count, qq, kf))
        queued = queued_ms(lambda: F.fused_topk_int8_raw(E_q, sc, count, qq, kf))
        plain = cuda_ms(lambda: F.fused_topk_int8_reference(E_q, sc, count, qq, kf))

        def library():
            s = (qq.to(torch.bfloat16) @ E_bf.T).float() * sc[:count]
            return torch.topk(s, kf, dim=1)

        lib = cuda_ms(library)
        b_ms, b_by = bound(count * D + count * 4 + Q * D * 2 + Q * kf * 8,
                           2 * Q * count * D, spec[2], spec)
        log(f"time fused_topk_int8 cap={cap} count={count} Q={Q} k={kf}: {ms:.4f} ms "
            f"(queued {queued:.4f} ms; plain {plain:.4f} ms, library {lib:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by}); max |err| vs plain {err:.2e}")
        res[Q] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                  "bound_by": b_by}
    return res[q.shape[0]], worst


def float_rows(g, cap, count, dev, dtype, crafted=False):
    """Seeded unit rows (or small integers) as f32/bf16; rows past count 0."""
    import torch

    if crafted:
        E = torch.randint(-2, 3, (cap, D), generator=g, device=dev).float()
    else:
        E = torch.randn((cap, D), generator=g, device=dev)
        E = E / torch.linalg.vector_norm(E, dim=1, keepdim=True)
    E[count:] = 0
    return E.to(dtype)


def _check_topk(v1, i1, v2, i2, rescore, exact, what):
    """Kernel (v1, i1) vs plain (v2, i2): the -inf pattern equal; with
    exact sums values and ids equal; else scores within 1e-5 (f32
    summation order) and ids equal except near-ties, which ``rescore``
    (query rows, ids -> f64 scores) must confirm within 2e-5."""
    import torch

    fin = torch.isfinite(v2)
    if not torch.equal(torch.isfinite(v1), fin):
        raise AssertionError(f"{what}: -inf slots differ")
    err = (v1[fin] - v2[fin]).abs().max().item() if fin.any() else 0.0
    if exact:
        if not (torch.equal(v1[fin], v2[fin]) and torch.equal(i1[fin], i2[fin])):
            raise AssertionError(f"{what}: exact-sum results differ")
        return err
    if err > 1e-5:
        raise AssertionError(f"{what}: scores differ by {err}")
    bad = (i1 != i2) & fin
    if bad.any():
        gap = (rescore(bad.nonzero()[:, 0], i1[bad].long()) - v2[bad].double()).abs().max().item()
        if gap > 2e-5:
            raise AssertionError(f"{what}: {int(bad.sum())} ids differ beyond near-ties "
                                 f"(gap {gap})")
        log(f"  {what}: {int(bad.sum())} of {int(fin.sum())} ids are near-tie swaps "
            f"(gap {gap:.2e})")
    return err


def check_binmax_float(g, dev):
    """binmax vs its plain version: within 1e-5 on unit rows (the tensor
    cores sum in another order), bit for bit on integer-valued rows."""
    import torch

    from modular_rag_system_tpu_torch.ops import binmax_topk as B

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for cap, bw, crafted in ((16384, 32, False), (65536, 64, False), (8192, 32, True)):
            E = float_rows(g, cap, cap - 13, dev, dtype, crafted)
            for Q in (1, 16, 256):
                q = (torch.randint(-1, 2, (Q, D), generator=g, device=dev).float()
                     if crafted else unit_queries(g, Q, dev))
                worst = max(worst, _check_dense(B.binmax_call(E, q, bw),
                                                B.binmax_reference(E, q, bw), crafted,
                                                f"binmax {dtype} cap={cap} Q={Q}"))
        log(f"kernel binmax {dtype}: caps 8192..65536, Q=1,16,256, bw 32/64 match "
            f"(integer rows bit-exact; max |err| {worst:.2e})")
    return worst


def check_fused_float(g, dev):
    import torch

    from modular_rag_system_tpu_torch.ops import fused_topk as F

    worst = 0.0
    Q = 16
    for dtype in (torch.float32, torch.bfloat16):
        for cap, count in ((1024, 1000), (4096, 4001)):
            E = float_rows(g, cap, count, dev, dtype)
            q = unit_queries(g, Q, dev)
            rescore = float_rescorer(E, q)
            for k in (1, 10, 100, 1024):
                if k > cap:
                    continue
                for bw in (None, 128):
                    v1, i1 = F.fused_topk_raw(E, count, q, k, bw)
                    v2, i2 = F.fused_topk_reference(E, count, q, k, bw)
                    torch.cuda.synchronize()
                    worst = max(worst, _check_topk(v1, i1, v2, i2, rescore, False,
                                                   f"fused_topk {dtype} cap={cap} k={k} bw={bw}"))
        v1, i1 = F.fused_topk_raw(E[:1024], 5, q, 10)
        v2, i2 = F.fused_topk_reference(E[:1024], 5, q, 10)
        _check_topk(v1, i1, v2, i2, rescore, False, f"fused_topk {dtype} count<k")
        if int(torch.isfinite(v1).sum(1).max()) != 5:
            raise AssertionError("fused_topk count<k: wrong number of live slots")
        E_t = float_rows(g, 4096, 3000, dev, dtype, crafted=True)
        q_t = torch.randint(-1, 2, (Q, D), generator=g, device=dev).float()
        for k, bw in ((16, None), (1024, None), (8, 128)):
            v1, i1 = F.fused_topk_raw(E_t, 3000, q_t, k, bw)
            v2, i2 = F.fused_topk_reference(E_t, 3000, q_t, k, bw)
            _check_topk(v1, i1, v2, i2, None, True, f"fused_topk {dtype} ties k={k} bw={bw}")
        log(f"kernel fused_topk {dtype}: k 1..1024, bw None/128, count<k, crafted ties "
            f"match (max |err| so far {worst:.2e})")
    return worst


def fine_case(g, dev, fine_dtype, nblocks, Q, L, dup=False):
    """A fine copy of seeded unit rows and per-query lists of distinct
    blocks with dead (vcnt 0) and partial slots; with ``dup`` block 1 is
    a copy of block 3 and the lists are just those two, so every row ties
    with its copy and the lower slot must win."""
    import torch

    from modular_rag_system_tpu_torch.ops.ivf2 import SLAB
    from modular_rag_system_tpu_torch.ops.quantize import quantize_rows

    x = torch.randn((nblocks * SLAB, D), generator=g, device=dev)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    if dup:
        x.view(nblocks, SLAB, D)[1] = x.view(nblocks, SLAB, D)[3]
    if fine_dtype == "int8":
        qv, sc = quantize_rows(x)
        E_c3, sc3 = qv.view(nblocks, SLAB, D), sc.view(nblocks, SLAB)
    else:
        E_c3, sc3 = x.to(torch.bfloat16).view(nblocks, SLAB, D), None
    blk = torch.stack([torch.randperm(nblocks, generator=g, device=dev)[:L]
                       for _ in range(Q)]).to(torch.int32)
    choices = torch.tensor([0, 1, 77, SLAB, SLAB], device=dev, dtype=torch.int32)
    vcnt = choices[torch.randint(0, 5, (Q, L), generator=g, device=dev)]
    if dup:  # the list is the two copies, full
        blk = torch.tensor([[3, 1]] * Q, dtype=torch.int32, device=dev)
        vcnt = torch.full((Q, 2), SLAB, dtype=torch.int32, device=dev)
    return E_c3, sc3, unit_queries(g, Q, dev), blk, vcnt


def check_fine_scores(g, dev):
    from modular_rag_system_tpu_torch.ops import ivf2 as V

    worst = 0.0
    for fdt in ("bf16", "int8"):
        for nblocks, Q, L in ((512, 16, 64), (2048, 4, 1024)):
            E_c3, sc3, q, blk, vcnt = fine_case(g, dev, fdt, nblocks, Q, L)
            worst = max(worst, _check_dense(V.fine_scores_call(E_c3, sc3, q, blk, vcnt),
                                            V.fine_scores_reference(E_c3, sc3, q, blk, vcnt),
                                            False, f"fine_scores {fdt} L={L}"))
    log(f"kernel fine_scores bf16/int8: partial and zero vcnt, -inf pattern identical, "
        f"max |err| {worst:.2e}")
    return worst


def _check_dump_ids(E_c3, sc3, q, blk, vcnt, k, slots, what):
    """The dump path on the same lists selects the same slots as the
    selecting kernel: both score a row with the same code, in the same
    order (the JAX package's invariant, ``tests/test_ivf.py``)."""
    import torch

    from modular_rag_system_tpu_torch.ops import ivf2 as V

    _, xs = V.fine_call_xla(E_c3, sc3, q, blk, vcnt, k)
    if not torch.equal(xs, slots):
        raise AssertionError(f"{what}: ids differ from the dump path's")


def check_fine_topk(g, dev):
    import torch

    from modular_rag_system_tpu_torch.ops import ivf2 as V

    worst = 0.0
    for fdt in ("bf16", "int8"):
        for nblocks, Q, L, k, dup in ((512, 16, 64, 20, False), (2048, 4, 1500, 128, False),
                                      (512, 16, 2, 40, True), (2048, 2, 1500, 20, False)):
            E_c3, sc3, q, blk, vcnt = fine_case(g, dev, fdt, nblocks, Q, L, dup)
            v1, s1 = V.fine_call(E_c3, sc3, q, blk, vcnt, k)
            v2, s2 = V.fine_topk_reference(E_c3, sc3, q, blk, vcnt, k)
            worst = max(worst, _check_topk(v1, s1, v2, s2, fine_rescorer(E_c3, sc3, q), False,
                                           f"fine_topk {fdt} L={L} k={k}"))
            _check_dump_ids(E_c3, sc3, q, blk, vcnt, k, s1, f"fine_topk {fdt} L={L}")
            if dup:  # tied pairs: the block-1 slot first
                fin = torch.isfinite(v1)
                pairs = s1[:, 0::2][fin[:, 0::2]] // V.SLAB
                if not (pairs == 1).all():
                    raise AssertionError(f"fine_topk {fdt}: ties not broken by lowest slot")
    log(f"kernel fine_topk bf16/int8: L 2..1500, k 20..128, ties by slot, ids equal "
        f"to the dump path's, max |err| {worst:.2e}")
    return worst


def time_binmax_float(idx, q, spec):
    """binmax at the ivf tier's k > 64 route's inputs (the engine's f32
    master at its capacity, bin width 64): held against its plain version
    within 1e-5, then timed.  Returns the timings at Q=len(q) and the max
    |error|."""
    import torch

    from modular_rag_system_tpu_torch.ops import binmax_topk as B

    E = idx.E
    cap, bw = E.shape[0], B.auto_bin_width(E.shape[0])
    nb = cap // bw
    res, worst = {}, 0.0
    for Q in (q.shape[0], 1):
        qq = q[:Q]
        qb = qq.to(torch.bfloat16)
        err = _check_dense(B.binmax_call(E, qq, bw), B.binmax_reference(E, qq, bw), False,
                           f"binmax at the k > 64 route's inputs, Q={Q}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: B.binmax_call(E, qq, bw))
        queued = queued_ms(lambda: B.binmax_call(E, qq, bw))
        plain = cuda_ms(lambda: B.binmax_reference(E, qq, bw), reps=3)

        E_bf = E.to(torch.bfloat16)

        def library():  # one cuBLAS bf16 GEMM + the bin max
            return (E_bf @ qb.T).view(nb, bw, Q).amax(1).T

        lib = cuda_ms(library, reps=5)
        del E_bf
        torch.cuda.empty_cache()
        b_ms, b_by = bound(cap * D * 4 + Q * D * 2 + Q * nb * 4, 2 * cap * Q * D,
                           spec[2], spec)
        log(f"time binmax cap={cap} bw={bw} Q={Q}: {ms:.4f} ms (queued {queued:.4f} ms; "
            f"plain {plain:.4f} ms, library {lib:.4f} ms, bound {b_ms:.4f} ms by {b_by}); "
            f"max |err| vs plain {err:.2e}")
        res[Q] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                  "bound_by": b_by}
    return res[q.shape[0]], worst


def time_fused_float(idx, q, spec):
    """fused_topk at the unbuilt ivf tier's inputs (the small engine's f32
    master, k = 10): held against its plain version, then timed.  Returns
    the timings at Q=len(q) and the max |error|."""
    import torch

    from modular_rag_system_tpu_torch.ops import fused_topk as F

    E, count, k = idx.E, idx.count, 10
    E_bf = E[:count].to(torch.bfloat16)
    res, worst = {}, 0.0
    for Q in (q.shape[0], 1):
        qq = q[:Q]
        v1, i1 = F.fused_topk_raw(E, count, qq, k)
        v2, i2 = F.fused_topk_reference(E, count, qq, k)
        err = _check_topk(v1, i1, v2, i2, float_rescorer(E, qq), False,
                          f"fused_topk at the unbuilt ivf route's inputs, Q={Q}")
        worst = max(worst, err)
        ms = cuda_ms(lambda: F.fused_topk_raw(E, count, qq, k))
        queued = queued_ms(lambda: F.fused_topk_raw(E, count, qq, k))
        plain = cuda_ms(lambda: F.fused_topk_reference(E, count, qq, k))

        def library():  # bf16 matmul + torch.topk
            return torch.topk((qq.to(torch.bfloat16) @ E_bf.T).float(), k, dim=1)

        lib = cuda_ms(library)
        b_ms, b_by = bound(count * D * 4 + Q * D * 2 + Q * k * 8, 2 * Q * count * D,
                           spec[2], spec)
        log(f"time fused_topk cap={E.shape[0]} count={count} Q={Q} k={k}: {ms:.4f} ms "
            f"(queued {queued:.4f} ms; plain {plain:.4f} ms, library {lib:.4f} ms, "
            f"bound {b_ms:.4f} ms by {b_by}); max |err| vs plain {err:.2e}")
        res[Q] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                  "bound_by": b_by}
    return res[q.shape[0]], worst


def probe_lists(idx, q, nprobe, sort):
    """The fine stage's block lists for queries q, as ``ivf2_search_core``
    builds them (sorted ascending, dead slots last, for the dump path)."""
    import torch

    from modular_rag_system_tpu_torch.ops import ivf2 as V
    from modular_rag_system_tpu_torch.ops.exact import stable_topk

    iv = idx._ivf2
    nprobe = min(nprobe, iv.n_clusters)
    L = iv.slots_for_nprobe(nprobe)
    U = V.auto_u(L)
    L = ((L + U - 1) // U) * U
    _, probes = stable_topk(q @ iv.centroids.T, nprobe)
    blk, vcnt = V.block_lists(probes, iv.blk_start, iv.nblk, iv.counts, L)
    if sort:
        order = torch.argsort(torch.where(vcnt > 0, blk, 2**30), dim=1, stable=True)
        blk, vcnt = torch.gather(blk, 1, order), torch.gather(vcnt, 1, order)
    return blk, vcnt


def _fine_bound(iv, blk, vcnt, out_bytes, spec):
    """Bytes: the live rows of each probed slab once (rows + scales; the
    kernels read no row at or past a slab's vcnt), the queries, the block
    lists and the output; operations: 2 d per row scored.  Also returns
    the bytes the per-query stream reads (a slab once per query probing
    it)."""
    import torch

    row_b = D * iv.E_c3.element_size() + (4 if iv.scales3 is not None else 0)
    live = vcnt > 0
    b, v = blk[live].long(), vcnt[live].long()
    slab_rows = torch.zeros(iv.E_c3.shape[0], dtype=torch.int64, device=blk.device)
    slab_rows[b] = v
    if not torch.equal(slab_rows[b], v):  # a block's vcnt is the same in every list
        raise AssertionError("a probed block has two live row counts")
    uniq = int((slab_rows > 0).sum())
    rows = int(vcnt.sum())
    per_query = rows * row_b
    nbytes = (int(slab_rows.sum()) * row_b + blk.shape[0] * D * 2 + 8 * blk.numel()
              + out_bytes)
    b_ms, b_by = bound(nbytes, 2 * rows * D, spec[2], spec)
    return b_ms, b_by, uniq, per_query


def time_fine(idx, q, nprobe, k, spec, selecting):
    """fine_scores (dump path) or fine_topk (selecting) at the engine's own
    probe lists: held against its plain version (and fine_topk's ids
    against the dump path's on the same lists), then timed.  Returns the
    timings at Q=len(q) and the max |error|."""
    from modular_rag_system_tpu_torch.ops import ivf2 as V

    iv = idx._ivf2
    res, worst = {}, 0.0
    name = "fine_topk" if selecting else "fine_scores"
    for Q in ((q.shape[0],) if selecting else (q.shape[0], 1)):
        qq = q[:Q]
        blk, vcnt = probe_lists(idx, qq, nprobe, sort=not selecting)
        if selecting:
            def fn():
                return V.fine_call(iv.E_c3, iv.scales3, qq, blk, vcnt, k)

            def plain_fn():
                return V.fine_topk_reference(iv.E_c3, iv.scales3, qq, blk, vcnt, k)

            out_bytes = Q * k * 8
        else:
            def fn():
                return V.fine_scores_call(iv.E_c3, iv.scales3, qq, blk, vcnt)

            def plain_fn():
                return V.fine_scores_reference(iv.E_c3, iv.scales3, qq, blk, vcnt)

            out_bytes = blk.numel() * 256 * 4
        what = f"{name} at the engine's nprobe={nprobe} lists, Q={Q}"
        if selecting:
            (v1, s1), (v2, s2) = fn(), plain_fn()
            err = _check_topk(v1, s1, v2, s2, fine_rescorer(iv.E_c3, iv.scales3, qq), False,
                              what)
            _check_dump_ids(iv.E_c3, iv.scales3, qq, blk, vcnt, k, s1, what)
        else:
            err = _check_dense(fn(), plain_fn(), False, what)
        worst = max(worst, err)
        ms = cuda_ms(fn, reps=10)
        queued = queued_ms(fn, reps=10)
        plain = cuda_ms(plain_fn, reps=2)
        b_ms, b_by, uniq, per_query = _fine_bound(iv, blk, vcnt, out_bytes, spec)
        log(f"time {name} {iv.fine_dtype} nprobe={nprobe} Q={Q} L={blk.shape[1]}: "
            f"{ms:.4f} ms (queued {queued:.4f} ms; plain {plain:.4f} ms, library none: "
            f"no single call; bound {b_ms:.4f} ms by {b_by}: {uniq} unique slabs; "
            f"the per-query stream reads {per_query / 1e9:.3f} GB); "
            f"max |err| vs plain {err:.2e}")
        res[Q] = {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
                  "bound_by": b_by}
    return res[q.shape[0]], worst


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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from modular_rag_system_tpu_torch import kernels

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
    before = sum(kernels.launches.values())
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.query_batch(batch, similarity_threshold=0.0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    launched = sum(kernels.launches.values()) - before
    # device activity only (a CPU op's device time repeats its kernels'),
    # as the union of the intervals, so nothing is counted twice
    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        busy_us += max(e - max(s, end), 0.0)
        end = max(end, e)
    busy = busy_us / 1e3
    recorded = sum(1 for ev in prof.events() if ev.device_type == DeviceType.CUDA
                   and any(name in ev.name for name in _PORT_KERNELS))
    log(f"{route} Q=256 query_batch under the profiler: wall {wall:.2f} ms, device "
        f"busy {busy:.2f} ms, device idle share {1 - busy / wall:.3f} ({recorded} of "
        f"{launched} launches of the port's kernels recorded)")


def drive(kernels, name, expect, fn):
    """Set every launch count to 0, drive a route, read the counts."""
    kernels.reset_launches()
    fn()
    counts = dict(kernels.launches)
    log(f"route {name}: launches {counts}")
    if counts[expect] == 0:
        raise AssertionError(f"route {name} launched no {expect} kernel")
    return counts[expect]


def run_route(eng, kernels, questions, name, expect):
    def fn():
        eng.query_batch(questions[:256], similarity_threshold=0.0)
        eng.query(questions[0], similarity_threshold=0.0)

    return drive(kernels, name, expect, fn)


def exact_topk_chunked(idx, q, k, chunk=16):
    """The exact tier's top-k over the index, 16 queries at a time (the
    (Q, capacity) score matrix of a whole batch would not fit beside an
    8,388,608-row master)."""
    import torch

    from modular_rag_system_tpu_torch.ops.exact import exact_topk_raw

    vals, rows = zip(*(exact_topk_raw(idx.E, idx.count, q[s:s + chunk], k)
                       for s in range(0, q.shape[0], chunk)))
    return torch.cat(vals), torch.cat(rows)


def check_against_exact(eng, q, k, tol, what):
    """The route's top-k ids against the exact tier's (recall@k) and the
    returned scores against the exact f32 scores of the returned rows."""
    import torch

    idx = eng.index
    with idx._lock:
        vals, rows = idx.search_core(k)(idx.search_ops(), idx.count, q)
        _, er = exact_topk_chunked(idx, q, k)
        got = torch.bmm(idx.E[rows.long()].float(), q.unsqueeze(2)).squeeze(2)
    recall = sum(len(set(a) & set(b)) for a, b in
                 zip(rows.tolist(), er.tolist())) / er.numel()
    err = (got - vals).abs().max().item()
    if err > tol:
        raise AssertionError(f"{what}: scores differ from exact scores by {err} > {tol}")
    log(f"{what} vs exact tier: recall@{k} {recall:.4f}, returned scores within "
        f"{err:.2e} of exact")
    return recall


def fill(eng, g, target):
    """Pre-embedded seeded unit rows (distinct contents) up to ``target``
    rows; the first batch tops the count up to a multiple of FILL_BATCH so
    the pow-2 padded appends keep the capacity a power of two."""
    import torch

    from modular_rag_system_tpu_torch.types import Document

    t0 = time.perf_counter()
    start = eng.index.count
    builds = []
    while eng.index.count < target:
        n = min(FILL_BATCH - eng.index.count % FILL_BATCH, target - eng.index.count)
        x = torch.randn((n, D), generator=g, device=g.device)
        x = (x / torch.linalg.vector_norm(x, dim=1, keepdim=True)).cpu().numpy()
        base = eng.index.count
        rebuilds = eng.index.ivf_rebuilds
        eng.add_documents([Document(content=f"filler row {base + i}", source="filler",
                                    embedding=x[i]) for i in range(n)])
        if eng.index.ivf_rebuilds != rebuilds:
            builds.append((eng.index.count, eng.index.ivf_last_build_s))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    filled = eng.index.count - start
    log(f"ingest filler: {filled} rows in {dt:.1f} s ({filled / dt:.0f} rows/s); "
        f"count {eng.index.count}, capacity {eng.index.capacity}")
    for count, secs in builds:
        iv = eng.index._ivf2
        log(f"  ivf build at {count} rows: {secs:.1f} s (k-means + splits + fill), "
            f"{iv.n_clusters} clusters, {iv.fine_dtype} fine copy "
            f"{iv.fine_bytes() / 1e9:.2f} GB, built {iv.built}")
    return builds


def phase(name, t0):
    log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    return time.perf_counter()


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    if not (ROOT / "modular_rag_system_tpu_torch").is_dir():
        print("chip_smoke: run from a checkout of the repository", file=sys.stderr)
        return 2
    # the engines' stores and snapshots (17.3 GB at the end), removed on exit
    work = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        return smoke(work)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def smoke(work: Path) -> int:
    import torch

    sys.path.insert(0, str(ROOT))
    from modular_rag_system_tpu_torch import RAGConfig, create_engine, kernels
    from modular_rag_system_tpu_torch.types import Document
    from modular_rag_system_tpu_torch.utils.device import resolve_device

    t_start = tp = time.perf_counter()
    smi = smi_line()
    name = torch.cuda.get_device_name(0)
    spec_name, spec = spec_for(name)
    log(f"device: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | "
        f"bound from the published {spec_name} spec {spec}")
    dev = resolve_device("cuda")

    # ---- phase 2: every kernel against its plain version
    t0 = time.perf_counter()
    kernels.build_all()
    log(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for kname, blog in kernels.build_logs.items():
        for line in blog.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {kname}: {line.strip()}")
    know, questions, passages = load_corpus()
    g = torch.Generator(device=dev).manual_seed(0)
    errs = {"binmax_int8": check_binmax(g, dev), "fused_topk_int8": check_fused(g, dev),
            "binmax": check_binmax_float(g, dev), "fused_topk": check_fused_float(g, dev),
            "fine_scores": check_fine_scores(g, dev), "fine_topk": check_fine_topk(g, dev)}
    torch.cuda.empty_cache()
    entries, launches = {}, {}
    tp = phase("2 (kernels)", tp)

    # ---- phase 3: the int8 routes, restart, the small ivf engine
    storage = str(work / "auto")
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
    launches["fused_topk_int8"] = run_route(eng, kernels, questions, "single-pass",
                                            "fused_topk_int8")
    entries["fused_topk_int8"], err = time_fused(eng, eng.embed_queries(questions[:256]), spec)
    errs["fused_topk_int8"] = max(errs["fused_topk_int8"], err)
    r_small = gold_recall(eng, questions, passages)
    lat1, qps = query_timings(eng, questions)
    query_breakdown(eng, questions, "single-pass route")
    log(f"single-pass route: gold recall@10 {r_small:.4f}, Q=1 latency {lat1:.2f} ms, "
        f"Q=256 {qps:.1f} QPS")
    if not r_small > 0.3:
        raise AssertionError(f"gold recall@10 {r_small} is implausibly low")

    fill_g = torch.Generator(device=dev).manual_seed(1)
    fill(eng, fill_g, FULL_ROWS)
    if eng.index.capacity != FULL_ROWS:
        raise AssertionError(f"capacity {eng.index.capacity} != {FULL_ROWS}")
    launches["binmax_int8"] = run_route(eng, kernels, questions, "two-pass", "binmax_int8")
    entries["binmax_int8"], err = time_binmax(eng, eng.embed_queries(questions[:256]), spec)
    errs["binmax_int8"] = max(errs["binmax_int8"], err)
    check_against_exact(eng, eng.embed_queries(questions[:256]), 10, 1e-5, "two-pass route")
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
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    eng2 = create_engine(cfg)
    after = eng2.query(questions[0], similarity_threshold=0.0)
    log(f"restart from snapshot: {time.perf_counter() - t0:.1f} s, "
        f"count {eng2.index.count}")
    if [d.id for d in before.documents] != [d.id for d in after.documents]:
        raise AssertionError("results changed across the restart")

    # the ivf tier below its build threshold serves the fused_topk route
    ivf_cfg = RAGConfig.load(overrides={"index.tier": "ivf",
                                        "store.storage_path": str(work / "ivf")})
    small = create_engine(ivf_cfg)
    small.add_documents([Document(content=t, source="knowledge") for t in know])
    for p in passages:
        small.add_text(p, source="qa")
    if small.index._ivf2 is not None or small.index.capacity != 4096:
        raise AssertionError("the small ivf engine should be unbuilt at capacity 4096")
    launches["fused_topk"] = run_route(small, kernels, questions, "ivf (unbuilt, fused)",
                                       "fused_topk")
    entries["fused_topk"], err = time_fused_float(small.index,
                                                  small.embed_queries(questions[:256]), spec)
    errs["fused_topk"] = max(errs["fused_topk"], err)
    r_ivf_small = gold_recall(small, questions, passages)
    log(f"unbuilt ivf route at {small.index.count} rows: gold recall@10 {r_ivf_small:.4f} "
        f"(int8 single-pass route {r_small:.4f})")
    if abs(r_ivf_small - r_small) > 0.05:
        raise AssertionError(f"gold recall {r_ivf_small} vs the int8 route's {r_small}")
    small.shutdown()
    del small
    tp = phase("3 (int8 routes, restart, small ivf engine)", tp)

    # ---- phase 4: the ivf route at full width
    idx = eng2.index
    fill(eng2, fill_g, IVF_ROWS)
    iv = idx._ivf2
    if (idx.effective_tier() != "ivf" or iv is None or iv.built != idx._AUTO_IVF_ROWS
            or iv.fine_dtype != "bf16" or idx.ivf_rebuilds != 1):
        raise AssertionError(f"expected the auto promotion at {idx._AUTO_IVF_ROWS} rows "
                             f"with a bf16 fine copy; got {eng2.get_system_stats()}")
    log(f"ivf stats: {eng2.get_system_stats()['index']['ivf']}")
    q256 = eng2.embed_queries(questions[:256])
    launches["fine_scores"] = run_route(eng2, kernels, questions, "ivf (bf16, exact tail)",
                                        "fine_scores")
    rec = check_against_exact(eng2, q256, 10, 1e-5, "ivf route (bf16 fine copy)")
    if rec < 0.9:
        raise AssertionError(f"ivf recall@10 {rec} below the 0.9 floor")
    r_ivf = gold_recall(eng2, questions, passages)
    log(f"ivf route at {idx.count} rows: gold recall@10 {r_ivf:.4f} "
        f"(two-pass route {r_full:.4f})")
    if r_ivf < r_full - 0.05:
        raise AssertionError(f"ivf gold recall {r_ivf} vs the two-pass route's {r_full}")

    # k = 2 x 50 > 64: the fused fallback, two-pass over the f32 master
    launches["binmax"] = drive(kernels, "ivf k=100 (fused two-pass)", "binmax",
                               lambda: eng2.query_batch(questions[:256], max_results=50,
                                                        similarity_threshold=0.0))
    # bf16 products of unit vectors: within 2^-8 of the exact f32 scores
    check_against_exact(eng2, q256, 100, 2.0**-8, "ivf k=100 route")
    entries["binmax"], err = time_binmax_float(idx, q256, spec)
    errs["binmax"] = max(errs["binmax"], err)

    # deep nprobe: the score dump would pass its per-query limit, so the
    # selecting kernel runs
    from modular_rag_system_tpu_torch.ops import ivf2 as V

    idx.ivf_nprobe = 512
    L = iv.slots_for_nprobe(512)
    log(f"nprobe 512: L = {L} slabs, dump path {V._use_dump(16, L)}")
    if V._use_dump(16, L):
        raise AssertionError("nprobe 512 should take the selecting kernel")
    launches["fine_topk"] = drive(kernels, "ivf nprobe=512 (selecting)", "fine_topk",
                                  lambda: eng2.query_batch(questions[:16],
                                                           similarity_threshold=0.0))
    rec = check_against_exact(eng2, q256[:16], 10, 1e-5, "ivf nprobe=512 route")
    if rec < 0.9:
        raise AssertionError(f"ivf nprobe=512 recall@10 {rec} below the 0.9 floor")
    entries["fine_topk"], err = time_fine(idx, q256[:16], 512, 20, spec, selecting=True)
    errs["fine_topk"] = max(errs["fine_topk"], err)
    idx.ivf_nprobe = 8
    tp = phase("4a (ivf promotion, k=100, nprobe 512)", tp)

    fill(eng2, fill_g, REBUILD_ROWS)
    iv = idx._ivf2
    if idx.ivf_rebuilds != 2 or iv.fine_dtype != "int8" or iv.built != REBUILD_ROWS:
        raise AssertionError(f"expected the int8 rebuild at {REBUILD_ROWS} rows; got "
                             f"{eng2.get_system_stats()['index']['ivf']}")
    log(f"ivf stats: {eng2.get_system_stats()['index']['ivf']}")
    q256 = eng2.embed_queries(questions[:256])
    run_route(eng2, kernels, questions, "ivf (int8)", "fine_scores")
    rec = check_against_exact(eng2, q256, 10, 1e-5, "ivf route (int8 fine copy)")
    if rec < 0.9:
        raise AssertionError(f"ivf recall@10 {rec} below the 0.9 floor")
    r_ivf = gold_recall(eng2, questions, passages)
    lat1, qps = query_timings(eng2, questions)
    query_breakdown(eng2, questions, "ivf route (int8)")
    log(f"ivf route at {idx.count} rows: gold recall@10 {r_ivf:.4f}, Q=1 latency "
        f"{lat1:.2f} ms, Q=256 {qps:.1f} QPS")
    if r_ivf < r_full - 0.05:
        raise AssertionError(f"ivf gold recall {r_ivf} vs the two-pass route's {r_full}")
    entries["fine_scores"], err = time_fine(idx, q256, 8, 20, spec, selecting=False)
    errs["fine_scores"] = max(errs["fine_scores"], err)
    tp = phase("4b (int8 rebuild, fine_scores timing)", tp)

    log(f"peak device memory so far {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    # restart: the snapshot's clustering warm-starts the rebuild
    free = shutil.disk_usage(storage).free
    log(f"storage {storage}: {free / 1e9:.1f} GB free for the "
        f"{idx.count * D * 4 / 1e9:.1f} GB snapshot")
    before = eng2.query(questions[0], similarity_threshold=0.0)
    t0 = time.perf_counter()
    eng2.shutdown()
    del eng2, idx, iv
    gc.collect()
    torch.cuda.empty_cache()
    log(f"shutdown (snapshot) {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    eng3 = create_engine(cfg)
    iv = eng3.index._ivf2
    log(f"restart from the {REBUILD_ROWS}-row snapshot: {time.perf_counter() - t0:.1f} s "
        f"(ivf rebuild {eng3.index.ivf_last_build_s:.1f} s)")
    if iv is None or not iv.warm_started or iv.built != REBUILD_ROWS or iv.fine_dtype != "int8":
        raise AssertionError("the restart's rebuild did not take the warm start")
    after = eng3.query(questions[0], similarity_threshold=0.0)
    if [d.id for d in before.documents] != [d.id for d in after.documents]:
        raise AssertionError("ivf results changed across the restart")
    eng3.shutdown()
    tp = phase("4c (snapshot, warm restart)", tp)

    out = []
    replaces = {"binmax_int8": "modular_rag_system_tpu/ops/binmax_topk.py:450",
                "fused_topk_int8": "modular_rag_system_tpu/ops/fused_topk.py:282",
                "binmax": "modular_rag_system_tpu/ops/binmax_topk.py:225",
                "fused_topk": "modular_rag_system_tpu/ops/fused_topk.py:147",
                "fine_scores": "modular_rag_system_tpu/ops/ivf2.py:763",
                "fine_topk": "modular_rag_system_tpu/ops/ivf2.py:529"}
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
