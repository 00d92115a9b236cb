#!/usr/bin/env python3
"""Chip smoke of the PyTorch port (``modular_rag_system_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device: the card's name and power limit (``nvidia-smi``);
2. kernels: builds every CUDA kernel from ``modular_rag_system_tpu_torch/
   kernels/*.cu`` (one ``nvcc`` per source, in parallel) and holds each
   of the nine against its plain PyTorch version on seeded inputs at d=768
   (crafted ties and integer-valued inputs that make the sums exact, a
   count that is no multiple of the bin width, count < k, each query tile
   of the single-pass launch plan, k up to 8192, dead and partial
   fine-stage slots in all three fine-copy modes, blocks shared by many
   queries with per-pair counts, slabs whose rows repeat, queries that
   all list the same bins, attention with ragged padding and an
   all-padding row at L = 1 to 2048);
3. engine: ``create_engine`` with the bundled hybrid encoder (dim 768),
   ``index.tier="auto"``: ingests the bundled knowledge sentences and QA
   passages as text (single-pass ``fused_topk_int8`` route), queries,
   then fills the index with seeded unit-norm rows to 1,048,576 rows
   (two-pass ``binmax_int8`` route) and queries again, holding the ids
   against the exact tier; restart from the snapshot; then a second
   engine with ``index.tier="ivf"`` over the bundled corpus (below the
   build threshold: the single-pass ``fused_topk`` route); a third with
   ``embedding.attention_impl="flash"`` (``mea_attention`` in every
   layer of every forward, its embeddings held against the dense
   engine's); on the 1,048,576-row index the two-pass functions with
   ``kernel_rescan=True`` (``rescan``) beside the gather they replace,
   and ``rescan``'s pair sort, score launch and select launches timed
   apart at Q = 256 and Q = 1;
4. ivf: the restarted engine fills on to 4,718,592 rows (the write path
   promotes ``auto`` to ivf at 4,194,304 rows with a bf16 fine copy and
   an exact tail; ``fine_scores`` route), a k = 100 query batch (the
   ``binmax`` two-pass fallback), one batch at nprobe 512 (the selecting
   ``fine_topk`` kernel), then on to 5,636,096 rows (the rebuild with an
   int8 fine copy), each held against the exact tier; kernel times at
   the engine's own inputs, ``fine_binmax`` (the fine stage's streaming
   floor; its runs, slab reads and rescored rows logged) among them; a filtered Q = 256 batch whose deep refill runs the
   exact top-k at k > 1,024 (its ids held against 16-query calls, its
   device memory logged); shutdown (a 17.3 GB snapshot) and a restart whose
   rebuild takes the saved clustering (no k-means); a second restart
   with ``index.ivf_fine_dtype="int4"``: the packed fine copy at half the
   int8 copy's bytes, the route at Q = 128, the refusal of Q = 256 (its
   rescore gather passes 1 GiB), and the int4 mode of the three fine
   kernels at the engine's own lists; then phase 4e, the sharded index:
   ``create_engine`` with ``mesh.index_shards=4`` and
   ``index_devices=[cuda:0] * 4`` over the 1,939 text rows
   (``fused_topk_int8`` once a shard and search), the 5,636,096-row
   snapshot restored into 4 shards (the ivf tier warm-started per shard
   with an int8 fine copy, ``fine_scores`` once a shard; the k = 100
   batch exact per shard, no kernel; the filtered deep refill through
   ``search_deep``; a cold sharded build with ``kmeans_fit_sharded``
   timed) and into a 2 x 2 layout with ``index.tier="int8"``
   (``binmax_int8`` once a shard); each route held against an exact
   reference that is each shard's exact top-k merged by this script;
5. entry points: ``EnhancedRAGSystem`` on the card (bundled hybrid
   encoder, ``index.tier="auto"``, its own storage) ingests the bundled
   knowledge sentences and QA passages as uploaded text files; the HTTP
   server answers the 316 QA questions as non-enhanced ``POST /query``
   from 16 concurrent clients (in a process of their own) through the
   query batcher, their ids held against one ``query_batch`` of the same
   questions, then once more under the profiler (the device's idle
   share), and one client's requests beside the engine calls they make;
   an enhanced query, an ``/add``, ``/health`` and ``/stats``; the
   lifecycle on documents with old timestamps (``cleanup_old_documents``,
   ``compact``, ``reembed_all``, each held against the answers before
   it); ``launcher --test`` in its own process.  Every search there is
   ``fused_topk_int8``'s single-pass route, and no other kernel launches;
6. train: ``ContrastiveTrainer`` on the card over the bundled encoder's
   dense half at full width (L = 128, bf16 over f32 masters), batches of
   256 QA pairs: step 0 held against the host CPU's loss of the same
   batch, 30 steps whose loss falls (step time, tokens/s, the bound,
   peak memory, the device's idle share; each step's update launches
   ``clip_adamw_norm`` and ``clip_adamw_apply`` once, and both, on a
   real step's gradient at the trainer's size, hold against their plain
   version clipped and unclipped and repeat bit for bit), a checkpoint
   round trip; then
   ``EnhancedRAGSystem.fine_tune_from_feedback`` on 64 feedback pairs
   (the serving encoder takes the trainer's weights, every live row is
   re-embedded, the 316 questions run ``fused_topk_int8`` alone with ids
   equal to the exact tier's), beside the ``build_default_encoder
   --smoke`` tool in a process of its own, whose asset must load and
   encode;
7. HF encoder: a BERT checkpoint at all-MiniLM-L6-v2's published widths
   (6 layers, hidden 384, 12 heads, FFN 1536, vocab 30,522, 512
   positions; random weights from a seeded generator) written by this
   script as ``config.json``, ``vocab.txt`` and ``model.safetensors``,
   served through ``embedding.hf_checkpoint`` at the default
   ``max_seq_len`` 256 in the default hybrid (index dim 768) and
   tokenized by the native engine: the corpus ingested, the questions at
   Q=256 and Q=1 (``fused_topk_int8``), ids against the exact tier, the
   card's bf16 embeddings against the f32 CPU forward (min cosine
   0.995); the same checkpoint with ``attention_impl="flash"``
   (``mea_attention`` in each of the 6 layers; timed alone at B = 256, L
   = 256); the native tokenizer's ids against the Python path's under
   the bundled and the checkpoint's vocab, both timed; the external
   eval's recall@10 of the shipped hybrid on the card and on the host
   CPU, equal within one pair of 304; then 7b, ModernBERT at
   ModernBERT-base's published widths and depth (22 layers: 8 global, 14
   with |i - j| <= 64; seeded weights, the bundled vocab padded to 50,368
   ids) served through ``embedding.hf_checkpoint`` at 8,192 positions
   with ``attention_impl="flash"``: ``add_documents`` of 8 long documents
   launches ``mea_attention`` once a global and ``mea_attention_window``
   once a local layer and forward, and no other kernel; both modes held
   against their plain version at the first global and the first local
   layer's inputs of that batch (8 x 8,192, 12 heads of 64, bf16, ragged
   padding) and timed there, the full mode in both its designs (the
   Hopper design the wrapper picks at that L, and the tile template),
   and both designs at L = 256 to 2,048 (B x H = 96): the crossover.
8. multihost: two processes on the card, one gloo group of 2
   (``parallel/multihost.py``): ``mh_check`` with CUDA tensors (its four
   markers in both ranks), then two ranks of this script
   (``--multihost-rank``), each: a ``mesh.multihost`` engine (bundled
   hybrid encoder, ``index.tier="auto"``, its own storage, 2 local shards
   of a 2 x 2 layout whose slices are the processes) ingests the text
   rows under the SPMD contract and answers the 316 questions at Q=256
   and Q=1 (``fused_topk_int8`` once a local shard and search), ids
   equal across the ranks and to phase 3's one device; filled with
   phase 3's seeded rows to 1,048,576 (``binmax_int8`` once a local shard
   and search), ids held against an exact top-k merged by the script;
   the trainer on (2, 1) and (1, 2) layouts at phase 6's width and
   batches (step 0 against phase 6's loss, 5 steps, a 255-pair batch
   with a clone row, a (1, 2) checkpoint restored on one device);
   ``fine_tune_from_feedback`` on the (1, 2) layout the group gives,
   then the questions through ``fused_topk_int8`` against the exact
   tier; the search stage, its all-gather, the step and the gradient
   all-reduce timed beside phases 4e and 6.

Each kernel is also held against its plain version at the inputs the
main path gives it (the engine's own rows, queries and probe lists), and
timed there with CUDA events (back-to-back calls, and one call queued
behind a device sleep), beside its plain version, one PyTorch library
call that computes the same function where there is one, and the card's
bound.  Kernel launch counts are set to 0 just before each route is
driven and read just after (``fused_topk_int8``'s entry also gives its
launches in phase 5's HTTP and lifecycle runs and phase 6's queries
after the fine-tune, and it and ``mea_attention``'s those of phase 7's
HF engines, both modes of ``mea_attention`` phase 7b's ingest; it and
``binmax_int8``'s each phase-8 rank's).  The last three lines are
the ``nvidia-smi`` line, the kernels JSON line and the result line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
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
# the device kernels the port's wrappers launch (fused_topk and
# fused_topk_int8 both run fused_topk_kernel, and over several row splits
# fused_topk_merge_kernel after it; fine_topk over several CTAs a query
# tile runs fine_topk_merge; rescan runs rescan_score, then
# rescan_select_warp or rescan_select_sort; mea_attention runs
# mea_bf16_kernel or mea_f32_kernel)
_PORT_KERNELS = ("binmax_int8_kernel", "binmax_kernel", "fused_topk_kernel",
                 "fused_topk_merge_kernel", "fine_scores_kernel", "fine_topk_kernel",
                 "fine_topk_merge", "fine_binmax_kernel", "rescan_score", "rescan_select_warp",
                 "rescan_select_sort", "mea_bf16_kernel", "mea_f32_kernel")
FINE_MODES = ("bf16", "int8", "int4")

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

    from modular_rag_system_tpu_torch.ops.ivf2 import SLAB, _fine_mode

    qb = q.to(torch.bfloat16).double()
    int4 = _fine_mode(E_c3) == "int4"

    def rows_at(slots):
        if not int4:
            return E_c3.reshape(-1, D)[slots].double()
        b, r = slots // SLAB, slots % SLAB
        t = E_c3[b, r % (SLAB // 2)].to(torch.int32)  # the packed bytes
        return torch.where((r < SLAB // 2)[:, None], t >> 4, ((t & 0xF) ^ 8) - 8).double()

    def rescore(qi, slots):
        r = (qb[qi] * rows_at(slots)).sum(1)
        return r if sc3 is None else r * sc3.reshape(-1)[slots].double()

    return rescore


def check_binmax(g, dev):
    """binmax_int8 vs its plain version, bit for bit."""
    import torch

    from modular_rag_system_tpu_torch.ops import binmax_topk as B

    for cap, Qs in ((8192, (1, 8, 16, 17, 129, 256, 300)), (FULL_ROWS, (1, 17, 256, 300))):
        count = cap - 13  # not a multiple of the bin width
        E_q, sc = quantized_rows(g, cap, count, dev)
        for Q in Qs:  # each query tile of the launch plan, and past 256
            q_i8, q_scale = B.quantize_queries(unit_queries(g, Q, dev))
            for bw in (32, 64):
                args = (E_q, sc, q_i8, q_scale, bw)
                _check_dense(B.binmax_int8_call(*args), B.binmax_int8_reference(*args), True,
                             f"binmax_int8 cap={cap} Q={Q} bw={bw}")
        log(f"kernel binmax_int8 cap={cap} count={count} Q={Qs}, bw 32 and 64: bit-exact")
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
        log(f"time binmax_int8 cap={cap} Q={Q} (query tile {B.binmax_int8_plan(Q, D)}): "
            f"{ms:.4f} ms (queued {queued:.4f} ms; "
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
    # the launch plan's edges: each query tile at the single-pass route's
    # size, bins of one and of several 128-row chunks, k = 8192 over one
    # and two splits (crafted: integer-valued, every tie exact)
    for cap, count, Qn, k, bw, crafted in (
            (4096, 1939, 1, 20, None, False), (4096, 1939, 17, 20, None, False),
            (4096, 1939, 256, 20, None, False), (4096, 1939, 300, 20, None, False),
            (4096, 3001, 256, 8, 128, True), (8192, 7000, 40, 10, 512, True),
            (16384, 16000, 1, 8192, None, True), (16384, 9000, 3, 8192, None, True)):
        if crafted:
            E_e = torch.randint(-2, 3, (cap, D), generator=g, device=dev).to(torch.int8)
            E_e[count:] = 0
            sc_e = torch.ones(cap, device=dev)
            q_e = torch.randint(-1, 2, (Qn, D), generator=g, device=dev).float()
        else:
            E_e, sc_e = quantized_rows(g, cap, count, dev)
            q_e = unit_queries(g, Qn, dev)
        v1, i1 = F.fused_topk_int8_raw(E_e, sc_e, count, q_e, k, bw)
        v2, i2 = F.fused_topk_int8_reference(E_e, sc_e, count, q_e, k, bw)
        torch.cuda.synchronize()
        worst = max(worst, _check_topk(v1, i1, v2, i2, int8_rescorer(E_e, sc_e, q_e), crafted,
                                       f"fused_topk_int8 cap={cap} count={count} Q={Qn} "
                                       f"k={k} bw={bw} (plan {F.fused_topk_plan(Qn, k, count, D, 1, bw or 1)})"))
    log(f"kernel fused_topk_int8: Q 1..300, k up to 8192, bw None/128/512 match "
        f"(max |err| so far {worst:.2e})")
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
        plan = F.fused_topk_plan(Q, kf, count, D, 1)
        log(f"time fused_topk_int8 cap={cap} count={count} Q={Q} k={kf} (plan cfg, QB, S, R "
            f"= {plan}): {ms:.4f} ms "
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
        for cap, bw, crafted in ((16384, 32, False), (65536, 64, False), (8192, 32, True),
                                 (16384, 8, False), (16384, 128, True)):
            E = float_rows(g, cap, cap - 13, dev, dtype, crafted)
            for Q in (1, 16, 256, 300):
                q = (torch.randint(-1, 2, (Q, D), generator=g, device=dev).float()
                     if crafted else unit_queries(g, Q, dev))
                worst = max(worst, _check_dense(B.binmax_call(E, q, bw),
                                                B.binmax_reference(E, q, bw), crafted,
                                                f"binmax {dtype} cap={cap} Q={Q}"))
        log(f"kernel binmax {dtype}: caps 8192..65536, Q=1,16,256,300, bw 8..128 match "
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
        # the launch plan's edges: each query tile, a count below one
        # 128-row split or no multiple of 128 with bins, bins of several
        # chunks, k > count, k = 8192 over one and two splits (crafted:
        # integer-valued, every tie exact)
        for cap, count, Qn, k, bw, crafted in (
                (4096, 1939, 1, 10, None, False), (4096, 1939, 17, 10, None, False),
                (4096, 1939, 256, 10, None, False), (4096, 1939, 300, 10, None, False),
                (4096, 3001, 300, 16, None, True), (1024, 50, 17, 10, None, False),
                (4096, 1000, 17, 10, 128, False), (4096, 3001, 256, 8, 128, True),
                (8192, 7000, 40, 10, 512, True), (1024, 700, 20, 1000, None, False),
                (16384, 16000, 1, 8192, None, True), (16384, 9000, 3, 8192, None, True)):
            E_e = float_rows(g, cap, count, dev, dtype, crafted)
            q_e = (torch.randint(-1, 2, (Qn, D), generator=g, device=dev).float() if crafted
                   else unit_queries(g, Qn, dev))
            v1, i1 = F.fused_topk_raw(E_e, count, q_e, k, bw)
            v2, i2 = F.fused_topk_reference(E_e, count, q_e, k, bw)
            torch.cuda.synchronize()
            err = _check_topk(v1, i1, v2, i2, float_rescorer(E_e, q_e), crafted,
                              f"fused_topk {dtype} cap={cap} count={count} Q={Qn} k={k} "
                              f"bw={bw}")
            worst = max(worst, err)
        log(f"kernel fused_topk {dtype}: k 1..8192, Q 1..300, bw None/128/512, count<k, "
            f"crafted ties match (max |err| so far {worst:.2e})")
    return worst


def fine_case(g, dev, fine_dtype, nblocks, Q, L, dup=False, shared=0):
    """A fine copy of seeded unit rows and per-query lists of distinct
    blocks with dead (vcnt 0) and partial slots; with ``dup`` block 1 is
    a copy of block 3 and the lists are just those two, so every row ties
    with its copy and the lower slot must win; with ``shared`` > 0 the
    lists draw from the first ``shared`` blocks (several queries probe each
    block, each pair with its own vcnt) and dead slots point at block 0,
    as ``block_lists`` writes them."""
    import torch

    from modular_rag_system_tpu_torch.ops.ivf2 import SLAB
    from modular_rag_system_tpu_torch.ops.quantize import quantize_int4_blocks, quantize_rows

    x = torch.randn((nblocks * SLAB, D), generator=g, device=dev)
    x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    if dup:
        x.view(nblocks, SLAB, D)[1] = x.view(nblocks, SLAB, D)[3]
    if fine_dtype == "int8":
        qv, sc = quantize_rows(x)
        E_c3, sc3 = qv.view(nblocks, SLAB, D), sc.view(nblocks, SLAB)
    elif fine_dtype == "int4":
        E_c3, sc3 = quantize_int4_blocks(x, nblocks, SLAB)
    else:
        E_c3, sc3 = x.to(torch.bfloat16).view(nblocks, SLAB, D), None
    blk = torch.stack([torch.randperm(shared or nblocks, generator=g, device=dev)[:L]
                       for _ in range(Q)]).to(torch.int32)
    # dead, partial (odd, below and above half a slab) and full slots
    choices = torch.tensor([0, 1, 77, 129, SLAB, SLAB], device=dev, dtype=torch.int32)
    vcnt = choices[torch.randint(0, 6, (Q, L), generator=g, device=dev)]
    if shared:
        blk[vcnt == 0] = 0
    if dup:  # the list is the two copies, full
        blk = torch.tensor([[3, 1]] * Q, dtype=torch.int32, device=dev)
        vcnt = torch.full((Q, 2), SLAB, dtype=torch.int32, device=dev)
    return E_c3, sc3, unit_queries(g, Q, dev), blk, vcnt


def check_fine_scores(g, dev):
    from modular_rag_system_tpu_torch.ops import ivf2 as V

    worst = dict.fromkeys(FINE_MODES, 0.0)
    for fdt in FINE_MODES:
        # the last case: Q = 256 over blocks shared by many queries with
        # per-pair vcnt and dead slots at block 0 (16 sorted pairs a CTA)
        for nblocks, Q, L, shared in ((512, 16, 64, 0), (2048, 4, 1024, 0),
                                      (512, 256, 40, 120)):
            E_c3, sc3, q, blk, vcnt = fine_case(g, dev, fdt, nblocks, Q, L, shared=shared)
            worst[fdt] = max(worst[fdt], _check_dense(
                V.fine_scores_call(E_c3, sc3, q, blk, vcnt),
                V.fine_scores_reference(E_c3, sc3, q, blk, vcnt), False,
                f"fine_scores {fdt} L={L} Q={Q}"))
    log(f"kernel fine_scores bf16/int8/int4: partial and zero vcnt, Q 4..256 (shared "
        f"blocks, per-pair vcnt: bf16/int8 P = "
        f"{V.fine_scores_plan(256, 40, D, 'int8', V._sm_count(dev))}), "
        f"-inf pattern identical, max |err| {worst}")
    return worst


def check_fine_binmax(g, dev):
    """fine_binmax vs its plain version, and equal to the row maximum of
    the dump kernel, which scores a row with the same code: lists of
    distinct blocks, Q = 1 (no pair sort), Q = 256 over blocks shared by
    many queries with per-pair vcnt and dead slots at block 0, and every
    odd row of a slab a copy of the row before it (the maximum ties with
    its copy)."""
    import torch

    from modular_rag_system_tpu_torch.ops import ivf2 as V

    worst = dict.fromkeys(FINE_MODES, 0.0)
    cands = []
    for fdt in FINE_MODES:
        for nblocks, Q, L, shared, dup in ((512, 16, 64, 0, False), (2048, 4, 1024, 0, False),
                                           (512, 1, 64, 0, False), (512, 256, 40, 120, False),
                                           (512, 256, 40, 120, True), (512, 16, 64, 0, True)):
            E_c3, sc3, q, blk, vcnt = fine_case(g, dev, fdt, nblocks, Q, L, shared=shared)
            if dup:  # stored rows: an int4 row holds logical rows r and r + 128
                E_c3[:, 1::2] = E_c3[:, 0::2]
                if sc3 is not None:
                    sc3[:, 1::2] = sc3[:, 0::2]
            counts = torch.zeros(blk.shape, dtype=torch.int32, device=dev)
            out = V.fine_binmax_call(E_c3, sc3, q, blk, vcnt, cand_counts=counts)
            what = f"fine_binmax {fdt} L={L} Q={Q} shared={shared} dup={dup}"
            worst[fdt] = max(worst[fdt], _check_dense(
                out, V.fine_binmax_reference(E_c3, sc3, q, blk, vcnt), False, what))
            dump = V.fine_scores_call(E_c3, sc3, q, blk, vcnt).view(Q, -1, V.SLAB)
            if not (torch.equal(out, dump.amax(dim=2))
                    and torch.equal(torch.isfinite(out), vcnt > 0)):
                raise AssertionError(f"{what}: not the dump's row maximum")
            live = vcnt > 0
            if not ((counts[live] >= 1).all() and (counts[live] <= vcnt[live]).all()):
                raise AssertionError(f"{what}: a live pair rescored no row or too many")
            cands.append(counts[live].float())
    c = torch.cat(cands)
    log(f"kernel fine_binmax bf16/int8/int4: Q 1..256 (shared blocks, per-pair vcnt, dead "
        f"slots at block 0), duplicated rows; -inf exactly on dead slots, equal to the dump "
        f"kernel's row maxima; rescored rows per live pair mean {c.mean().item():.2f}, max "
        f"{int(c.max().item())}; max |err| vs plain {worst}")
    return worst


def _check_dump_ids(E_c3, sc3, q, blk, vcnt, k, slots, vals, what):
    """The dump path on the same lists selects the same slots as the
    selecting kernel, with the same scores bit for bit: the selecting
    kernel's returned scores are fine_scores' own arithmetic (the JAX
    package's invariant, ``tests/test_ivf.py``)."""
    import torch

    from modular_rag_system_tpu_torch.ops import ivf2 as V

    xv, xs = V.fine_call_xla(E_c3, sc3, q, blk, vcnt, k)
    if not torch.equal(xs, slots):
        raise AssertionError(f"{what}: ids differ from the dump path's")
    if not torch.equal(xv, vals):
        raise AssertionError(f"{what}: scores differ from the dump path's")


def check_fine_topk(g, dev):
    import torch

    from modular_rag_system_tpu_torch.ops import ivf2 as V

    worst = dict.fromkeys(FINE_MODES, 0.0)
    for fdt in FINE_MODES:
        # L 2..1500; more queries than one tile over blocks shared by many
        # queries with per-pair vcnt and dead slots at block 0; k to 8192
        for nblocks, Q, L, k, dup, shared in (
                (512, 16, 64, 20, False, 0), (2048, 4, 1500, 128, False, 0),
                (512, 16, 2, 40, True, 0), (2048, 2, 1500, 20, False, 0),
                (512, 40, 40, 20, False, 60), (512, 300, 24, 20, False, 48),
                (512, 20, 100, 300, False, 120), (512, 3, 300, 8192, False, 0)):
            E_c3, sc3, q, blk, vcnt = fine_case(g, dev, fdt, nblocks, Q, L, dup, shared)
            v1, s1 = V.fine_call(E_c3, sc3, q, blk, vcnt, k)
            v2, s2 = V.fine_topk_reference(E_c3, sc3, q, blk, vcnt, k)
            worst[fdt] = max(worst[fdt], _check_topk(
                v1, s1, v2, s2, fine_rescorer(E_c3, sc3, q), False,
                f"fine_topk {fdt} L={L} k={k}"))
            _check_dump_ids(E_c3, sc3, q, blk, vcnt, k, s1, v1, f"fine_topk {fdt} L={L}")
            if dup:  # tied pairs: the block-1 slot first
                fin = torch.isfinite(v1)
                pairs = s1[:, 0::2][fin[:, 0::2]] // V.SLAB
                if not (pairs == 1).all():
                    raise AssertionError(f"fine_topk {fdt}: ties not broken by lowest slot")
    log(f"kernel fine_topk bf16/int8/int4: L 2..1500, Q 2..300 (shared blocks, per-pair "
        f"vcnt, dead slots at block 0), k 20..8192, ties by slot, ids and scores equal to "
        f"the dump path's, max |err| {worst}")
    return worst


def _straddle_bins(g, dev, Q, nb, kb, straddle, shared=False):
    """(Q, kb) distinct random bin ids per query, unsorted, the bin that
    holds the live/dead boundary among them; with ``shared`` one set of
    bins for every query, in another order for each."""
    import torch

    if shared:
        first = torch.randperm(nb, generator=g, device=dev)[:kb]
        if not (first == straddle).any():
            first[0] = straddle
        bins = torch.stack([first[torch.randperm(kb, generator=g, device=dev)]
                            for _ in range(Q)])
        return bins.to(torch.int32)
    bins = torch.stack([torch.randperm(nb, generator=g, device=dev)[:kb] for _ in range(Q)])
    has = (bins == straddle).any(dim=1)
    bins[:, 0] = torch.where(has, bins[:, 0], straddle)
    return bins.to(torch.int32)


def check_rescan(g, dev):
    """rescan vs its plain version on f32 and bf16 stores: unit rows within
    1e-5 (ids equal except near-ties), integer-valued rows with crafted
    ties exactly; a count inside a bin; fewer candidates than k; every
    query listing the same bins (runs longer than a chunk), at Q = 16 and
    256."""
    import torch

    from modular_rag_system_tpu_torch.ops import binmax_topk as B

    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for cap, count, k, kb, bw, crafted, Q, shared in (
                (16384, 16001, 10, 13, 32, False, 16, False),
                (65536, 65523, 100, 103, 64, False, 16, False),
                (8192, 7001, 16, 19, 32, True, 16, False), (8192, 8000, 100, 2, 32, False, 16, False),
                (8192, 5, 10, 13, 32, False, 16, False), (8192, 7001, 16, 19, 32, True, 16, True),
                (65536, 65523, 10, 14, 32, False, 256, True),
                (65536, 65523, 100, 102, 32, False, 256, True)):
            E = float_rows(g, cap, count, dev, dtype, crafted)
            q = (torch.randint(-1, 2, (Q, D), generator=g, device=dev).float()
                 if crafted else unit_queries(g, Q, dev))
            bins = _straddle_bins(g, dev, Q, cap // bw, kb, min(count, cap - 1) // bw, shared)
            v1, i1 = B.rescan_call(E, bins, count, q, k, bw)
            v2, i2 = B.rescan_reference(E, bins, count, q, k, bw)
            what = (f"rescan {dtype} cap={cap} count={count} k={k} kb={kb} bw={bw} Q={Q} "
                    f"shared={shared}")
            worst = max(worst, _check_topk(v1, i1, v2, i2, float_rescorer(E, q), crafted, what))
            if not (i1[~torch.isfinite(v1)] == -1).all():
                raise AssertionError(f"{what}: an empty slot carries an id")
            if int(torch.isfinite(v1).sum(1).max()) > min(k, kb * bw, count):
                raise AssertionError(f"{what}: more live slots than live candidates")
    log(f"kernel rescan f32/bf16: crafted ties exact, a count inside a bin, count < k, "
        f"kb x bin_width < k, all queries sharing their bins (Q 16 and 256); max |err| "
        f"{worst:.2e}")
    return worst


def _mea_tolerance(ref):
    """f32: 1e-5 (summation order, exp).  bf16: the probabilities and the
    output are rounded to bf16, so a last-bit difference in f32 can move
    an output by one bf16 step, 2^-7 of its magnitude."""
    import torch

    if ref.dtype == torch.float32:
        return torch.full_like(ref, 1e-5)
    return 2.0**-7 * ref.float().abs() + 1e-5


def _check_mea(out, ref, what):
    import torch

    if not torch.isfinite(out).all():
        raise AssertionError(f"{what}: non-finite output")
    d = (out.float() - ref.float()).abs()
    if not (d <= _mea_tolerance(ref)).all():
        raise AssertionError(f"{what}: differs from its plain version, max |d| "
                             f"{d.max().item()}")
    return d.max().item()


def check_mea(g, dev):
    """mea_attention vs its plain version: f32 and bf16, ragged padding, an
    all-padding batch row, dh 32 and 64, L off and on the tile sizes.
    Returns the max |error| per dtype."""
    import torch

    from modular_rag_system_tpu_torch.ops import flash_attention as FA

    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        w = 0.0
        for B_, L, H, dh in ((3, 40, 12, 32), (3, 128, 12, 32), (2, 600, 4, 64),
                             (2, 2048, 12, 32), (2, 2048, 2, 64), (4, 1, 12, 32),
                             (256, 32, 12, 32), (2, 100, 3, 40)):
            q, k, v = (torch.randn((B_, L, H, dh), generator=g, device=dev).to(dtype)
                       for _ in range(3))
            pad = torch.ones((B_, L), dtype=torch.int32, device=dev)
            pad[0, L * 5 // 8:] = 0  # ragged padding
            pad[-1] = 0              # an all-padding batch row
            w = max(w, _check_mea(FA.mea_attention(q, k, v, pad),
                                  FA.mea_attention_reference(q, k, v, pad),
                                  f"mea_attention {dtype} L={L} dh={dh}"))
        worst[dtype] = w
    log(f"kernel mea_attention: L 1..2048, dh 32/40/64, ragged and all-padding rows finite; "
        f"max |err| f32 {worst[torch.float32]:.2e} (tolerance 1e-5), bf16 "
        f"{worst[torch.bfloat16]:.2e} (tolerance one bf16 step, 2^-7 |ref| + 1e-5)")
    return worst


def time_binmax_float(idx, q, spec):
    """binmax at the ivf tier's k > 64 route's inputs (the engine's f32
    master at its capacity, bin width 64), and over a bf16 copy of it (the
    bf16 tier's pass 1): held against its plain version within 1e-5, then
    timed beside one cuBLAS bf16 GEMM + bin max on the bf16 copy.  Returns
    the timings at Q=len(q) over the f32 rows (with those over the bf16
    rows under "bf16_rows") and the max |error|."""
    import torch

    from modular_rag_system_tpu_torch.ops import binmax_topk as B

    E = idx.E
    cap, bw = E.shape[0], B.auto_bin_width(E.shape[0])
    nb = cap // bw
    E_bf = E.to(torch.bfloat16)
    res, worst = {}, 0.0
    for rows, M in (("f32", E), ("bf16", E_bf)):
        for Q in (q.shape[0], 1):
            qq = q[:Q]
            qb = qq.to(torch.bfloat16)
            err = _check_dense(B.binmax_call(M, qq, bw), B.binmax_reference(M, qq, bw), False,
                               f"binmax at the k > 64 route's inputs, {rows} rows, Q={Q}")
            worst = max(worst, err)
            ms = cuda_ms(lambda: B.binmax_call(M, qq, bw))
            queued = queued_ms(lambda: B.binmax_call(M, qq, bw))
            plain = cuda_ms(lambda: B.binmax_reference(M, qq, bw), reps=3)

            def library():  # one cuBLAS bf16 GEMM + the bin max
                return (E_bf @ qb.T).view(nb, bw, Q).amax(1).T

            lib = cuda_ms(library, reps=5)
            b_ms, b_by = bound(cap * D * M.element_size() + Q * D * 2 + Q * nb * 4,
                               2 * cap * Q * D, spec[2], spec)
            log(f"time binmax {rows} rows cap={cap} bw={bw} Q={Q}: {ms:.4f} ms (queued "
                f"{queued:.4f} ms; plain {plain:.4f} ms, library {lib:.4f} ms, bound "
                f"{b_ms:.4f} ms by {b_by}); max |err| vs plain {err:.2e}")
            res[rows, Q] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                            "bound_by": b_by}
    del E_bf
    torch.cuda.empty_cache()
    entry = dict(res["f32", q.shape[0]])
    entry["bf16_rows"] = res["bf16", q.shape[0]]
    return entry, worst


def time_fused_float(idx, q, spec):
    """fused_topk at the unbuilt ivf tier's inputs (the small engine's f32
    master, k = 10), and over a bf16 copy of its live rows (the bf16
    tier's rows): held against its plain version, then timed.  Returns
    the timings at Q=len(q) over the f32 rows (with those over the bf16
    rows under "bf16_rows") and the max |error|."""
    import torch

    from modular_rag_system_tpu_torch.ops import fused_topk as F

    E, count, k = idx.E, idx.count, 10
    E_bf = E[:count].to(torch.bfloat16)
    res, worst = {}, 0.0
    for rows, M in (("f32", E), ("bf16", E_bf)):
        for Q in (q.shape[0], 1):
            qq = q[:Q]
            v1, i1 = F.fused_topk_raw(M, count, qq, k)
            v2, i2 = F.fused_topk_reference(M, count, qq, k)
            err = _check_topk(v1, i1, v2, i2, float_rescorer(M, qq), False,
                              f"fused_topk at the unbuilt ivf route's inputs, {rows} rows, "
                              f"Q={Q}")
            worst = max(worst, err)
            ms = cuda_ms(lambda: F.fused_topk_raw(M, count, qq, k))
            queued = queued_ms(lambda: F.fused_topk_raw(M, count, qq, k))
            plain = cuda_ms(lambda: F.fused_topk_reference(M, count, qq, k))

            def library():  # bf16 matmul + torch.topk
                return torch.topk((qq.to(torch.bfloat16) @ E_bf.T).float(), k, dim=1)

            lib = cuda_ms(library)
            b_ms, b_by = bound(count * D * M.element_size() + Q * D * 2 + Q * k * 8,
                               2 * Q * count * D, spec[2], spec)
            plan = F.fused_topk_plan(Q, k, count, D, M.element_size())
            log(f"time fused_topk {rows} rows cap={M.shape[0]} count={count} Q={Q} k={k} "
                f"(plan cfg, QB, S, R = {plan}): {ms:.4f} ms (queued {queued:.4f} ms; "
                f"plain {plain:.4f} ms, library {lib:.4f} ms, bound {b_ms:.4f} ms by "
                f"{b_by}); max |err| vs plain {err:.2e}")
            res[rows, Q] = {"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
                            "bound_by": b_by}
    entry = dict(res["f32", q.shape[0]])
    entry["bf16_rows"] = res["bf16", q.shape[0]]
    return entry, worst


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
    kernels read no row at or past a slab's vcnt; an int4 row is half a
    byte a value), the queries, the block lists and the output;
    operations: 2 d per row scored.  Also returns the bytes the per-query
    stream reads (a slab once per query probing it)."""
    import torch

    row_b = {"bf16": 2 * D, "int8": D + 4, "int4": D // 2 + 4}[iv.fine_dtype]
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


def fine_scores_sweep(iv, q, blk, vcnt, Ps):
    """The fine_scores kernel alone at each P of ``Ps`` (its entry called
    directly, on pairs sorted once beforehand): queued ms by P; the scores
    must not change with P."""
    import torch

    from modular_rag_system_tpu_torch import kernels
    from modular_rag_system_tpu_torch.ops import ivf2 as V

    mode = V._fine_mode(iv.E_c3)
    qb, b, v, sc = V._kernel_operands(iv.E_c3, iv.scales3, q, blk, vcnt, mode)
    Q, L = b.shape
    perm = V.fine_pair_keys(b, v, Q, iv.E_c3.shape[0])[1]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    outs, res = [], {}
    for P in Ps:
        out = torch.empty((Q, L * V.SLAB), dtype=torch.float32, device=q.device)

        def fn(P=P, out=out):
            kernels.launch("fine_scores", iv.E_c3.data_ptr(), V._MODE_IDS[mode], sc.data_ptr(),
                           qb.data_ptr(), b.data_ptr(), v.data_ptr(),
                           perm.data_ptr() if P > 1 else None, Q, L, D, P, out.data_ptr(),
                           stream)

        res[P] = queued_ms(fn, reps=10)
        outs.append(out)
    if not all(torch.equal(outs[0], o) for o in outs[1:]):
        raise AssertionError(f"fine_scores: the scores change with P ({Ps})")
    return res


def time_fine(idx, q, nprobe, k, spec, name):
    """fine_scores (dump path), fine_topk (selecting) or fine_binmax (the
    maxima probe) at the engine's own probe lists: held against its plain
    version (fine_topk's ids also against the dump path's on the same
    lists, fine_binmax also against the dump's row maxima), then timed.
    Returns the timings at Q=len(q) and the max |error|."""
    import torch

    from modular_rag_system_tpu_torch.ops import binmax_topk as B
    from modular_rag_system_tpu_torch.ops import ivf2 as V

    iv = idx._ivf2
    res, worst = {}, 0.0
    selecting = name == "fine_topk"
    for Q in ((q.shape[0],) if selecting else (q.shape[0], 1)):
        qq = q[:Q]
        blk, vcnt = probe_lists(idx, qq, nprobe, sort=not selecting)
        ops = (iv.E_c3, iv.scales3, qq, blk, vcnt)
        if selecting:
            kernel, plain_version = V.fine_call, V.fine_topk_reference
            args, out_bytes = ops + (k,), Q * k * 8
        elif name == "fine_binmax":
            kernel, plain_version = V.fine_binmax_call, V.fine_binmax_reference
            args, out_bytes = ops, blk.numel() * 4
        else:
            kernel, plain_version = V.fine_scores_call, V.fine_scores_reference
            args, out_bytes = ops, blk.numel() * 256 * 4

        def fn(kernel=kernel, args=args):
            return kernel(*args)

        def plain_fn(plain_version=plain_version, args=args):
            return plain_version(*args)

        what = f"{name} ({iv.fine_dtype}) at the engine's nprobe={nprobe} lists, Q={Q}"
        if selecting:
            (v1, s1), (v2, s2) = fn(), plain_fn()
            err = _check_topk(v1, s1, v2, s2, fine_rescorer(iv.E_c3, iv.scales3, qq), False,
                              what)
            _check_dump_ids(iv.E_c3, iv.scales3, qq, blk, vcnt, k, s1, v1, what)
        else:
            out = fn()
            err = _check_dense(out, plain_fn(), False, what)
            if name == "fine_binmax" and not torch.equal(
                    out, V.fine_scores_call(*ops).view(Q, -1, V.SLAB).amax(dim=2)):
                raise AssertionError(f"{what}: not the dump's row maximum")
        worst = max(worst, err)
        ms = cuda_ms(fn, reps=10)
        queued = queued_ms(fn, reps=10)
        plain = cuda_ms(plain_fn, reps=2)
        b_ms, b_by, uniq, per_query = _fine_bound(iv, blk, vcnt, out_bytes, spec)
        if name == "fine_scores":  # the launch plan, and the slab reads of its chunks
            P = V.fine_scores_plan(Q, blk.shape[1], D, iv.fine_dtype,
                                   V._sm_count(qq.device))
            nb = iv.E_c3.shape[0]
            keys = (V.fine_pair_keys(blk, vcnt, Q, nb)[0] if P > 1
                    else torch.where(vcnt > 0, blk, nb).reshape(-1).long())
            at = torch.arange(keys.numel(), device=keys.device)
            starts = (keys < nb) & ((at % P == 0) | (keys != torch.roll(keys, 1)))
            log(f"fine_scores plan at nprobe={nprobe} Q={Q}: P {P} pairs a CTA, "
                f"{-(-keys.numel() // P)} CTAs; {int((keys < nb).sum())} live pairs in "
                f"{int(starts.sum())} runs (slab reads; {uniq} unique slabs)")
            if Q > 1:  # the plan's P beside others, and what the pair sort costs
                sweep = fine_scores_sweep(iv, qq, blk, vcnt, (1, 2, 8, 16))
                sort_ms = queued_ms(lambda: V.fine_pair_keys(blk, vcnt, Q, nb), reps=10)
                log(f"fine_scores kernel alone (pairs sorted beforehand), queued ms by P: "
                    + ", ".join(f"P={pp} {t:.4f}" for pp, t in sweep.items())
                    + f"; the pair sort {sort_ms:.4f} ms queued")
        if name == "fine_binmax":  # the runs, and the rows the certificate rescored
            nb = iv.E_c3.shape[0]
            keys, _ = V.fine_binmax_pairs(blk, vcnt, nb)
            if keys is None:  # list order: each live pair its own run
                keys, W = torch.where(vcnt > 0, blk, nb).reshape(-1), 1
            else:
                W = B.pair_window(keys.numel(), V._sm_count(qq.device))
            counts = torch.zeros(blk.shape, dtype=torch.int32, device=qq.device)
            V.fine_binmax_call(*ops, cand_counts=counts)
            c = counts[vcnt > 0].float()
            table = (f"; the pair sort {queued_ms(lambda: V.fine_binmax_pairs(blk, vcnt, nb), reps=10):.4f} "
                     f"ms queued" if Q > 1 else "; no pair sort at Q = 1")
            log(f"fine_binmax plan at nprobe={nprobe} Q={Q}: {int((vcnt > 0).sum())} live pairs in "
                f"{window_runs(keys, W, nb)} runs of windows of {W} (slab reads; {uniq} unique "
                f"slabs); rescored rows per live pair mean {c.mean().item():.3f}, max "
                f"{int(c.max().item())}{table}")
        if selecting:  # the launch plan, and the slab reads of its query tiles
            cfg, QB, G = V.fine_topk_plan(Q, blk.shape[1], k, D, iv.fine_dtype,
                                          V._sm_count(qq.device))
            keys, _ = V.fine_pair_keys(blk, vcnt, QB, iv.E_c3.shape[0])
            live = keys % (iv.E_c3.shape[0] + 1) < iv.E_c3.shape[0]
            log(f"fine_topk plan at nprobe={nprobe} Q={Q} k={k}: cfg {cfg} "
                f"({V._FINE_STAGES[cfg]} ring stages), {QB} queries a tile, "
                f"{-(-Q // QB)} tiles x {G} CTAs; {int(live.sum())} live pairs in "
                f"{int(torch.unique(keys[live]).numel())} work items (slab reads; "
                f"{uniq} unique slabs)")
        log(f"time {name} {iv.fine_dtype} nprobe={nprobe} Q={Q} L={blk.shape[1]}: "
            f"{ms:.4f} ms (queued {queued:.4f} ms; plain {plain:.4f} ms, library none: "
            f"no single call; bound {b_ms:.4f} ms by {b_by}: {uniq} unique slabs; "
            f"the per-query stream reads {per_query / 1e9:.3f} GB); "
            f"max |err| vs plain {err:.2e}")
        res[Q] = {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
                  "bound_by": b_by}
    return res[q.shape[0]], worst


def window_runs(keys, W, nb=None):
    """The runs the rescan and fine_binmax kernels read one bin or slab
    for: in windows of W sorted keys, the positions that start a window
    or follow another key (below ``nb``, the dead key, where given)."""
    import torch

    at = torch.arange(keys.numel(), device=keys.device)
    start = (at % W == 0) | (keys != torch.roll(keys, 1))
    if nb is not None:
        start &= keys < nb
    return int(start.sum())


def rescan_stages(E, bins, count, q, k, bw):
    """The rescan kernel's pair sort, and its score and select launches
    called alone (its entry point, on pairs sorted beforehand): the window
    size, the runs (bin reads) and unique bins, and the queued ms of the
    sort, the score launch and each select launch (the warp selection
    where k <= 32; both selects must agree)."""
    import torch

    from modular_rag_system_tpu_torch import kernels
    from modular_rag_system_tpu_torch.ops import binmax_topk as B

    cap = E.shape[0]
    Q, kb = bins.shape
    qb = q.to(torch.bfloat16).contiguous()
    keys, perm = B.rescan_pairs(bins, cap // bw)
    ws = torch.empty((Q, kb * bw), dtype=torch.int64, device=E.device)
    outs = {}
    stream = torch.cuda.current_stream(E.device).cuda_stream

    def stage(stages, warp_sel):
        vals = torch.empty((Q, k), dtype=torch.float32, device=E.device)
        ids = torch.empty((Q, k), dtype=torch.int32, device=E.device)
        if stages == 2:
            outs[warp_sel] = (vals, ids)
        return lambda: kernels.launch(
            "rescan", E.data_ptr(), int(E.dtype == torch.bfloat16), qb.data_ptr(),
            keys.data_ptr(), keys.element_size(), None if perm is None else perm.data_ptr(),
            B.pair_window(Q * kb, B._sm_count(E.device)), Q, D, int(count), kb, bw, k,
            ws.data_ptr(), stages, warp_sel, vals.data_ptr(), ids.data_ptr(), stream)

    res = {"pair sort": queued_ms(lambda: B.rescan_pairs(bins, cap // bw), reps=10),
           "score": queued_ms(stage(1, 0), reps=10),
           "select (sort)": queued_ms(stage(2, 0), reps=10)}
    if k <= B._RESCAN_WARP_SELECT_K:
        res["select (warp)"] = queued_ms(stage(2, 1), reps=10)
        if not (torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])):
            raise AssertionError("rescan: the warp selection and the sort disagree")
    W = B.pair_window(Q * kb, B._sm_count(E.device))
    return W, window_runs(keys, W), int(torch.unique(bins).numel()), res


def time_rescan(eng, q, spec, kernels):
    """The two-pass functions with ``kernel_rescan=True`` on the index's own
    tensors and the embedded questions: the int8 route over the f32 master
    at k = 10 and the f32 route at k = 100.  Each drives the ``rescan``
    kernel (counted), is held against the gather path it replaces, and the
    kernel against its plain version on the route's own bins; then timed.
    Returns the k = 10 timings, the launches and the max |error|."""
    import torch

    from modular_rag_system_tpu_torch.ops import binmax_topk as B

    E_q, sc, E = eng.index.search_ops()
    count, cap = eng.index.count, E.shape[0]
    bw, nb, Q = B.auto_bin_width(cap), cap // B.auto_bin_width(cap), q.shape[0]
    rescore = float_rescorer(E, q)
    qd = q.double()
    res, worst, launched = {}, 0.0, 0
    for route, k in (("int8 master", 10), ("f32", 100)):
        if route == "f32":
            def twopass(kr):
                return B.twopass_topk_raw(E, count, q, k, bw, kernel_rescan=kr)

            kb = min(k + 1 + B._MARGIN_BINS, nb)
            binmax = B.binmax_call(E, q, bw)
        else:
            def twopass(kr):
                return B.twopass_topk_int8_master_raw(E_q, sc, E, count, q, k, bw,
                                                      kernel_rescan=kr)

            kb = min(k + 1 + B._MARGIN_BINS + B._INT8_MIXED_EXTRA_BINS, nb)
            binmax = B.binmax_int8_call(E_q, sc, *B.quantize_queries(q), bw)
        what = f"rescan on the {route} route, k={k}, Q={Q}"
        kernels.reset_launches()
        v1, i1 = twopass(True)
        n = kernels.launches["rescan"]
        log(f"route two-pass {route} k={k} kernel_rescan=True: launches "
            f"{dict(kernels.launches)}")
        if n == 0:
            raise AssertionError(f"{what}: the route launched no rescan kernel")
        launched += n
        v2, i2 = twopass(False)
        if route == "f32":  # one scoring space: equal except near-ties
            _check_topk(v1, i1, v2, i2, rescore, False, f"{what} vs the gather path")
        else:
            # the gather path scores the f32 master in true f32, the kernel
            # in bf16 products (within 2^-8 on unit vectors): an id that
            # only the kernel returns must score, in f64, within 2^-7 of the
            # gather path's k-th value
            if (v1 - v2).abs().max().item() > 2.0**-8:
                raise AssertionError(f"{what}: scores off the gather path's by more than 2^-8")
            only = (i1[:, :, None] != i2[:, None, :]).all(dim=2)
            if only.any():
                qi = only.nonzero()[:, 0]
                true = (qd[qi] * E[i1[only].long()].double()).sum(1)
                if (true < v2[qi, -1].double() - 2.0**-7).any():
                    raise AssertionError(f"{what}: ids differ beyond bf16 near-ties")
            log(f"  {what}: {int(only.sum())} of {i1.numel()} ids differ from the gather "
                f"path's (bf16-product near-ties, confirmed in f64), scores within "
                f"{(v1 - v2).abs().max().item():.2e}")
        # the kernel alone on the route's own bins, against its plain version
        bins = B.select_bins(B._mask_bins(binmax, count, nb, bw), kb)
        pv, pi = B.rescan_reference(E, bins, count, q, k, bw)
        kv, ki = B.rescan_call(E, bins, count, q, k, bw)
        err = _check_topk(kv, ki, pv, pi, rescore, False, what)
        worst = max(worst, err)
        ms = cuda_ms(lambda: B.rescan_call(E, bins, count, q, k, bw))
        queued = queued_ms(lambda: B.rescan_call(E, bins, count, q, k, bw))
        plain = cuda_ms(lambda: B.rescan_reference(E, bins, count, q, k, bw), reps=5)
        t_kernel = cuda_ms(lambda: twopass(True), reps=5)
        t_gather = cuda_ms(lambda: twopass(False), reps=5)
        # bytes: each bin that any query scans once (similar queries share
        # bins), the queries, the bin lists and the output
        uniq = int(torch.unique(bins).numel())
        bin_b = bw * D * E.element_size()
        b_ms, b_by = bound(uniq * bin_b + Q * D * 2 + Q * kb * 4 + Q * k * 8,
                           2 * Q * kb * bw * D, spec[2], spec)
        for qn in (Q, 1):  # the run plan, and each launch alone
            W, nch, nu, st = rescan_stages(E, bins[:qn], count, q[:qn], k, bw)
            log(f"rescan plan on the {route} route, k={k}, Q={qn}: {qn * kb} pairs in {nch} "
                f"runs of windows of {W} (bin reads; {nu} unique bins); queued ms: "
                + ", ".join(f"{n} {t:.4f}" for n, t in st.items())
                + f"; the whole call {queued_ms(lambda qn=qn: B.rescan_call(E, bins[:qn], count, q[:qn], k, bw), reps=10):.4f}")
        log(f"time rescan {route} cap={cap} Q={Q} k={k} kb={kb} bw={bw}: {ms:.4f} ms "
            f"(queued {queued:.4f} ms; plain (gather, product, sort) {plain:.4f} ms, "
            f"library none: no single call; bound {b_ms:.4f} ms by {b_by}: {uniq} unique "
            f"bins; the per-query stream reads {Q * kb * bin_b / 1e9:.3f} GB); the whole "
            f"two-pass search {t_kernel:.4f} ms with the kernel, {t_gather:.4f} ms with "
            f"the gather; max |err| vs plain {err:.2e}")
        res[k] = {"ms": ms, "plain_ms": plain, "library_ms": None, "bound_ms": b_ms,
                  "bound_by": b_by}
    return res[10], launched, worst


def time_mea(q, k, v, pad, spec, what, window=None):
    """mea_attention at the given inputs (``window``: its window mode, keys
    with |i - j| <= window): held against its plain version, then timed
    beside it and one ``scaled_dot_product_attention`` call with the key
    mask (and the band).  Bound: q, k, v and the output once each against
    the kernel's 6 dh operations a scored pair (two sweeps over k: the TPU
    kernel's rounding needs the row's final maximum before p v), B H L^2
    pairs or B H times the band's; the one-sweep count, 4 dh a pair, is
    reported beside it."""
    import torch
    import torch.nn.functional as F

    from modular_rag_system_tpu_torch.models.modernbert import band_pairs
    from modular_rag_system_tpu_torch.ops import flash_attention as FA

    B_, L, H, dh = q.shape
    err = _check_mea(FA.mea_attention(q, k, v, pad, window),
                     FA.mea_attention_reference(q, k, v, pad, window), f"mea_attention {what}")
    ms = cuda_ms(lambda: FA.mea_attention(q, k, v, pad, window), reps=10)
    queued = queued_ms(lambda: FA.mea_attention(q, k, v, pad, window), reps=10)
    plain = cuda_ms(lambda: FA.mea_attention_reference(q, k, v, pad, window), reps=3)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))  # (B, H, L, dh) views
    mask = (pad > 0)[:, None, None, :]
    if window is not None:
        pos = torch.arange(L, device=q.device)
        mask = mask & ((pos[:, None] - pos[None, :]).abs() <= window)
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask), reps=10)
    del mask
    peak = spec[2] if q.dtype == torch.bfloat16 else 67e12
    pairs = B_ * H * (L * L if window is None else band_pairs(L, window))
    nbytes = 4 * q.numel() * q.element_size() + pad.numel() * 4
    b_ms, b_by = bound(nbytes, 6 * pairs * dh, peak, spec)
    b4_ms, b4_by = bound(nbytes, 4 * pairs * dh, peak, spec)
    mode = "" if window is None else f" window={window}"
    log(f"time mea_attention{mode} {what} B={B_} L={L} H={H} dh={dh} {q.dtype}: {ms:.4f} ms "
        f"(queued {queued:.4f} ms; plain {plain:.4f} ms, library {lib:.4f} ms "
        f"(scaled_dot_product_attention with the key mask{' and the band' if mode else ''}), "
        f"bound {b_ms:.4f} ms by {b_by} (two sweeps; one sweep {b4_ms:.4f} ms by {b4_by})); "
        f"max |err| vs plain {err:.2e}")
    return ({"ms": ms, "plain_ms": plain, "library_ms": lib, "bound_ms": b_ms,
             "bound_by": b_by, "bound_ms_one_sweep": b4_ms}, err)


# ---------------------------------------------------------------------------
# phase 3: the engine
def load_corpus():
    train = ROOT / "modular_rag_system_tpu" / "assets" / "train"
    know = json.loads((train / "knowledge.json").read_text())["sentences"]
    items = json.loads((train / "qa_pairs.json").read_text())["items"]
    return know, [it["query"] for it in items], [it["passage"] for it in items]


def gold_recall(eng, questions, passages, k=10, batch=None):
    """Share of the questions whose gold passage is among the k results
    (``batch`` questions a call; None = all in one)."""
    batch = batch or len(questions)
    res = [r for s in range(0, len(questions), batch)
           for r in eng.query_batch(questions[s:s + batch], max_results=k,
                                    similarity_threshold=0.0)]
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


def device_busy_ms(prof) -> float:
    """Device time of a profile: device activity only (a CPU op's device
    time repeats its kernels'), as the union of the intervals, so
    nothing is counted twice."""
    from torch.autograd import DeviceType

    spans = sorted((ev.time_range.start, ev.time_range.end) for ev in prof.events()
                   if ev.device_type == DeviceType.CUDA)
    busy_us, end = 0.0, float("-inf")
    for s, e in spans:
        busy_us += max(e - max(s, end), 0.0)
        end = max(end, e)
    return busy_us / 1e3


def query_breakdown(eng, questions, route):
    """Wall time of each stage of one query call at Q=1 and Q=256 (each
    stage synchronized), and the device's busy share over one
    ``query_batch`` from ``torch.profiler``.  Returns {Q: {stage: ms}}."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from modular_rag_system_tpu_torch import kernels

    dense, lex = eng.encoder.dense, eng.encoder.lexical
    times = {}
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
        times[Q] = {name: wall_ms(fn, reps=5) for name, fn in stages.items()}
        parts = ", ".join(f"{name} {ms:.2f} ms" for name, ms in times[Q].items())
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
    busy = device_busy_ms(prof)
    recorded = sum(1 for ev in prof.events() if ev.device_type == DeviceType.CUDA
                   and any(name in ev.name for name in _PORT_KERNELS))
    log(f"{route} Q=256 query_batch under the profiler: wall {wall:.2f} ms, device "
        f"busy {busy:.2f} ms, device idle share {1 - busy / wall:.3f} ({recorded} device "
        f"kernels of the port recorded for {launched} wrapper launches)")
    return times


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
    """The exact tier's top-k over the index, 16 queries a call: a
    reference for the routes, and for the exact path itself, since at 16
    queries its block holds the whole live prefix (at 256 it walks
    1,048,576-row blocks)."""
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


def exact_refill(eng, questions):
    """A filtered Q=256 ``query_batch`` that only the QA passages' rows
    pass, asking 300 results: the first pass already asks k = 1,200 > 1,024,
    so the engine's deep refill serves it through ``exact_topk_raw`` (and
    deepens to k = 16,384 while a query has too few matches).  Each exact
    call's ids are held against ``exact_topk_chunked`` (16 queries a call:
    one block over the whole index, where 256 queries walk it in blocks),
    and the device memory the step needs beyond what the index holds is
    logged beside what the whole (Q, capacity) selection would hold."""
    import torch

    from modular_rag_system_tpu_torch.ops import exact as X

    idx, calls, raw = eng.index, [], X.exact_topk_raw

    def spy(E, count, q, k, block_rows=None):
        out = raw(E, count, q, k, block_rows)
        calls.append((q.clone(), k, out))
        return out

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    X.exact_topk_raw = spy
    t0 = time.perf_counter()
    try:
        res = eng.query_batch(questions[:256], max_results=300, source_filters=["qa"],
                              similarity_threshold=0.0)
    finally:
        X.exact_topk_raw = raw
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    Q, cap = len(res), idx.capacity
    whole = Q * cap * 4 * 4  # scores, their masked copy, sorted values, int64 positions
    log(f"exact refill (Q={Q}, source filter 'qa', max_results 300) at {idx.count} rows: "
        f"exact calls (Q, k) {[(c[0].shape[0], c[1]) for c in calls]}, {dt:.1f} s; "
        f"device memory: resident {resident / 1e9:.2f} GB, peak {peak / 1e9:.2f} GB "
        f"({(peak - resident) / 1e9:.2f} GB for the step; block rows "
        f"{X.exact_block_rows(Q, idx.dim, idx.E.dtype != torch.float32, calls[-1][1] if calls else 0)}"
        f"); the whole (Q, capacity) selection would add at least {whole / 1e9:.1f} GB "
        f"before its sort's scratch; "
        f"card {torch.cuda.get_device_properties(0).total_memory / 1e9:.1f} GB; "
        f"matches returned per query {min(len(r.documents) for r in res)}.."
        f"{max(len(r.documents) for r in res)}")
    if not any(q.shape[0] == Q and k > 1024 for q, k, _ in calls):
        raise AssertionError("the filtered batch did not reach the exact path at k > 1024")
    for q, k, (v1, i1) in calls:
        v2, i2 = exact_topk_chunked(idx, q, k)
        E = idx.E
        qd = q.double()
        _check_topk(v1, i1, v2, i2,
                    lambda qi, rows: (qd[qi] * E[rows].double()).sum(1), False,
                    f"exact top-k (blocks) at Q={q.shape[0]}, k={k}, vs 16 queries a call")
    return dt


def fill(eng, g, target):
    """Pre-embedded seeded unit rows (distinct contents) up to ``target``
    rows; the first batch tops the count up to a multiple of FILL_BATCH so
    the pow-2 padded appends keep the capacity a power of two.  The
    documents carry explicit ids in row order: the store's unique index
    on ``id`` then grows by appends, where content-hash ids (random keys)
    make every insert a random page of a multi-million-row B-tree."""
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
                                    embedding=x[i], id=f"filler-{base + i:010d}")
                           for i in range(n)])
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


def flash_engine(work, kernels, dense_eng, know, questions, passages, r_int8, spec, dev):
    """A small engine with ``embedding.attention_impl="flash"`` over the
    bundled corpus: every forward launches ``mea_attention`` once a layer;
    its embeddings are held against the dense engine's, its gold recall
    against the int8 route's, and the kernel is held against its plain
    version and timed at the engine's own (B, L) and, alone, at long
    sequences.  Returns the engine-shape timings, the route's launches and
    the max |error|."""
    import torch

    from modular_rag_system_tpu_torch import RAGConfig, create_engine
    from modular_rag_system_tpu_torch.models import encoder as encoder_module
    from modular_rag_system_tpu_torch.types import Document

    cfg = RAGConfig.load(overrides={"index.tier": "auto",
                                    "embedding.attention_impl": "flash",
                                    "store.storage_path": str(work / "flash")})
    eng = create_engine(cfg)
    dense = eng.encoder.dense
    layers = len(dense.module.blocks)
    if dense.module.attention_impl != "flash" or dense.module.dtype != torch.bfloat16:
        raise AssertionError("expected the bf16 flash encoder")
    forwards = [0]
    forward_tokens = dense.forward_tokens

    def counted(ids, mask):
        forwards[0] += 1
        return forward_tokens(ids, mask)

    dense.forward_tokens = counted
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng.add_documents([Document(content=t, source="knowledge") for t in know])
    for p in passages:
        eng.add_text(p, source="qa")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n = kernels.launches["mea_attention"]
    log(f"flash engine ingest: {eng.index.count} rows in {dt:.2f} s "
        f"({eng.index.count / dt:.1f} rows/s), {forwards[0]} forwards x {layers} layers, "
        f"{n} mea_attention launches")
    if n != layers * forwards[0] or n == 0:
        raise AssertionError(f"{n} mea_attention launches for {forwards[0]} forwards")
    forwards[0] = 0
    launched = run_route(eng, kernels, questions, "flash encoder (int8 single-pass search)",
                         "mea_attention")
    if launched != layers * forwards[0]:
        raise AssertionError(f"{launched} mea_attention launches for {forwards[0]} forwards")
    dense.forward_tokens = forward_tokens

    # the dense halves of the two engines' embeddings (the lexical halves
    # are the same host code): bf16 models, two attention arithmetics
    e_f = dense.encode_device(questions)
    e_d = dense_eng.encoder.dense.encode_device(questions)
    cos = (e_f * e_d).sum(1)
    log(f"flash vs dense encoder over {len(questions)} questions (bf16): min cosine "
        f"{cos.min().item():.6f}, max |d| {(e_f - e_d).abs().max().item():.2e} "
        f"(floor: cosine 0.999)")
    if not (torch.isfinite(e_f).all() and cos.min().item() >= 0.999):
        raise AssertionError("flash embeddings differ from the dense encoder's")
    r_flash = gold_recall(eng, questions, passages)
    lat1, qps = query_timings(eng, questions)
    log(f"flash engine: gold recall@10 {r_flash:.4f} (int8 route {r_int8:.4f}), "
        f"Q=1 latency {lat1:.2f} ms, Q=256 {qps:.1f} QPS")
    if abs(r_flash - r_int8) > 0.05:
        raise AssertionError(f"flash gold recall {r_flash} vs the int8 route's {r_int8}")

    # the kernel at the engine's own inputs: the first layer's q, k, v of a
    # 256-question forward
    captured = []
    mea = encoder_module.mea_attention

    def capture(q, k, v, pad):
        if not captured:
            captured.append((q.clone(), k.clone(), v.clone(), pad.clone()))
        return mea(q, k, v, pad)

    encoder_module.mea_attention = capture
    try:
        eng.embed_queries(questions[:256])
    finally:
        encoder_module.mea_attention = mea
    entry, err = time_mea(*captured[0], spec, "at the engine's first layer, Q=256")
    eng.shutdown()

    # alone: a 256-row batch at the bundled encoder's max_len, and the
    # lengths the TPU kernel was written for
    g = torch.Generator(device=dev).manual_seed(2)
    for B_, L in ((256, 128), (8, 2048), (8, 4096)):
        q, k, v = (torch.randn((B_, L, 12, 32), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        pad = torch.ones((B_, L), dtype=torch.int32, device=dev)
        pad[0, L * 3 // 4:] = 0
        _, e = time_mea(q, k, v, pad, spec, f"alone (B x H = {B_ * 12})")
        err = max(err, e)
    del q, k, v
    torch.cuda.empty_cache()
    return entry, launched, err


def int4_route(storage, kernels, V, questions, passages, spec, rec_int8, r_full,
               int8_fine_bytes, entries4, launches4, errs4):
    """Restart the 5,636,096-row snapshot with ``index.ivf_fine_dtype=
    "int4"``: the snapshot holds the clustering, the fine copy is rebuilt
    packed.  Drives the route at Q = 128, checks the refusal of Q = 256,
    and holds and times the int4 mode of the three fine kernels at the
    engine's own lists."""
    import torch

    from modular_rag_system_tpu_torch import RAGConfig, create_engine

    cfg = RAGConfig.load(overrides={"index.tier": "auto", "index.ivf_fine_dtype": "int4",
                                    "store.storage_path": storage,
                                    "store.snapshot_on_shutdown": False})
    t0 = time.perf_counter()
    eng = create_engine(cfg)
    idx, iv = eng.index, eng.index._ivf2
    log(f"restart with an int4 fine copy: {time.perf_counter() - t0:.1f} s (ivf rebuild "
        f"{idx.ivf_last_build_s:.1f} s); ivf stats {eng.get_system_stats()['index']['ivf']}")
    if (iv is None or not iv.warm_started or iv.built != REBUILD_ROWS
            or iv.fine_dtype != "int4" or iv.E_c3.shape[1] != V.SLAB // 2):
        raise AssertionError("the int4 restart did not warm-start a packed fine copy")
    ratio = iv.fine_bytes() / int8_fine_bytes
    log(f"int4 fine copy {iv.fine_bytes() / 1e9:.2f} GB, {ratio:.3f} of the int8 copy's "
        f"{int8_fine_bytes / 1e9:.2f} GB")
    if not 0.45 <= ratio <= 0.55:
        raise AssertionError(f"int4 fine copy is {ratio} of the int8 copy")

    batch = questions[:128]
    q128 = eng.embed_queries(batch)

    def route():
        eng.query_batch(batch, similarity_threshold=0.0)
        eng.query(questions[0], similarity_threshold=0.0)

    launches4["fine_scores"] = drive(kernels, "ivf (int4, Q=128)", "fine_scores", route)
    rec = check_against_exact(eng, q128, 10, 1e-5, "ivf route (int4 fine copy, Q=128)")
    log(f"ivf recall@10 vs the exact tier: int4 copy {rec:.4f}, int8 copy {rec_int8:.4f}")
    if rec < 0.9:
        raise AssertionError(f"int4 ivf recall@10 {rec} below the 0.9 floor")
    r_int4 = gold_recall(eng, questions, passages, batch=128)
    lat1 = statistics.median(wall_ms(lambda t=t: eng.query(t, similarity_threshold=0.0),
                                     reps=1) for t in questions[1:11])
    t_b = wall_ms(lambda: eng.query_batch(batch, similarity_threshold=0.0), reps=5)
    log(f"ivf route (int4) at {idx.count} rows: gold recall@10 {r_int4:.4f}, Q=1 latency "
        f"{lat1:.2f} ms, Q=128 {len(batch) / (t_b / 1e3):.1f} QPS")
    if r_int4 < r_full - 0.05:
        raise AssertionError(f"int4 gold recall {r_int4} vs the two-pass route's {r_full}")

    # Q = 256: the default over-selection's rescore gather passes the cap
    k = eng._initial_k(eng.config.retrieval.max_results, False)
    L = probe_lists(idx, q128[:1], idx.ivf_nprobe, sort=False)[0].shape[1]
    kf = min(k + max(10 * k, L * V.SLAB // 12), L * V.SLAB)
    for Q in (128, 256):
        log(f"int4 rescore gather at Q={Q}, k={k}, L={L}: {Q * kf * D * 4} bytes, cap "
            f"{V._RESCORE_MAX_BYTES}")
    if not 128 * kf * D * 4 <= V._RESCORE_MAX_BYTES < 256 * kf * D * 4:
        raise AssertionError("expected Q=128 under and Q=256 over the rescore cap")
    try:
        eng.query_batch(questions[:256], similarity_threshold=0.0)
    except ValueError as exc:
        want = (f"int4 master rescore would gather {256 * kf * D * 4 >> 20} MiB "
                f"(Q=256, pool={L * V.SLAB}, refine_extra={kf - k}); cap is "
                f"{V._RESCORE_MAX_BYTES >> 20} MiB.")
        if not str(exc).startswith(want):
            raise AssertionError(f"refusal message {str(exc)!r} != {want!r}...") from exc
        log(f"Q=256 refused: {exc}")
    else:
        raise AssertionError("the int4 route served Q=256 past its rescore cap")

    for name in ("fine_scores", "fine_topk", "fine_binmax"):
        if name != "fine_scores":  # reached by a direct call, as the tools do
            blk, vcnt = probe_lists(idx, q128, idx.ivf_nprobe, sort=name == "fine_binmax")
            call = ((lambda: V.fine_call(iv.E_c3, iv.scales3, q128, blk, vcnt, 20))
                    if name == "fine_topk" else
                    (lambda: V.fine_binmax_call(iv.E_c3, iv.scales3, q128, blk, vcnt)))
            launches4[name] = drive(kernels, f"{name} (direct call, int4)", name, call)
        entries4[name], err = time_fine(idx, q128, idx.ivf_nprobe, 20, spec, name)
        errs4[name] = max(errs4[name], err)
    log(f"peak device memory since the exact refill "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    eng.shutdown()


# ---------------------------------------------------------------------------
# phase 4e: the sharded index, 4 shards on the one card
SHARDS = 4
# the sharded deep refill's queries: the route and its k = 16,384 depth
# as at Q=256, at an eighth of the store fetch (Q=256 took 90.7 s of a
# 1,063 s smoke on an H100 80GB HBM3)
SHARDED_REFILL_Q = 32


def _live_s(idx, s):
    return max(0, (idx.count - s + idx.S - 1) // idx.S)


def sharded_exact(idx, q, k):
    """The exact top-k over a sharded index without the package's merge:
    each shard's exact top-k (``exact_topk_raw`` over its live rows, at
    the same queries as the route, so the same arithmetic), merged here by
    two stable sorts (global id, then score descending) -> (vals, gids
    int64) on q's device."""
    import torch

    from modular_rag_system_tpu_torch.ops.exact import exact_topk_raw

    S, vals, gids = idx.S, [], []
    for s, E_s in enumerate(idx.E):
        v, r = exact_topk_raw(E_s, _live_s(idx, s), q.to(E_s.device), min(k, idx.cap_s))
        vals.append(v.to(q.device))
        gids.append(torch.where(torch.isfinite(v), r.long() * S + s, 2**62).to(q.device))
    v, g = torch.cat(vals, 1), torch.cat(gids, 1)
    o = torch.argsort(g, dim=1, stable=True)
    v, g = v.gather(1, o), g.gather(1, o)
    o = torch.argsort(v, dim=1, descending=True, stable=True)[:, :k]
    return v.gather(1, o), g.gather(1, o)


def sharded_rows(idx, gids):
    """The master rows of global ids (Q, k) -> (Q, k, d) f32."""
    import torch

    g = gids.long().clamp(min=0)
    rows = torch.empty(g.shape + (idx.dim,), dtype=torch.float32, device=g.device)
    for s, E_s in enumerate(idx.E):
        m = g % idx.S == s
        rows[m] = E_s[(g[m] // idx.S).to(E_s.device)].float().to(g.device)
    return rows


def check_sharded(eng, q, k, tol, what, equal=False):
    """The sharded route's top-k (through the index's own protocol, as the
    engine calls it) against ``sharded_exact``: recall@k, and the returned
    scores against the exact f32 scores of the returned rows; with
    ``equal`` the ids and scores must equal the reference's."""
    import torch

    idx = eng.index
    with idx._lock:
        vals, gids = idx.search_core(k)(idx.search_ops(k), idx.count, q)
        ev, eg = sharded_exact(idx, q, k)
        got = torch.bmm(sharded_rows(idx, gids), q.unsqueeze(2)).squeeze(2)
    recall = sum(len(set(a) & set(b)) for a, b in
                 zip(gids.tolist(), eg.tolist())) / eg.numel()
    fin = torch.isfinite(vals)
    err = (got[fin] - vals[fin]).abs().max().item()
    if err > tol:
        raise AssertionError(f"{what}: scores differ from exact scores by {err} > {tol}")
    if equal and not (torch.equal(gids.long(), eg) and torch.equal(vals, ev)):
        raise AssertionError(f"{what}: ids or scores differ from the exact reference")
    log(f"{what} vs the exact reference: recall@{k} {recall:.4f}, returned scores within "
        f"{err:.2e} of exact{', ids and scores equal' if equal else ''}")
    return recall


def drive_shards(kernels, name, expect, fn, calls):
    """``drive``, and the route launched ``expect`` once per shard and search."""
    n = drive(kernels, name, expect, fn)
    if n != SHARDS * calls:
        raise AssertionError(f"route {name}: {n} {expect} launches, expected "
                             f"{SHARDS} shards x {calls} searches")
    return n


def sharded_refill(eng, questions, single_s):
    """Phase 4b''s filtered batch on the sharded index, at Q =
    ``SHARDED_REFILL_Q``: the deep refill reaches k = 1,200 and 16,384
    through ``search_deep`` (exact per shard, then the merge); each call's
    ids and scores held equal to ``sharded_exact``'s at the same queries."""
    import numpy as np
    import torch

    idx, calls, raw = eng.index, [], eng.index.search_deep

    def spy(q, k):
        out = raw(q, k)
        calls.append((q, k, out))
        return out

    idx.search_deep = spy
    t0 = time.perf_counter()
    try:
        res = eng.query_batch(questions[:SHARDED_REFILL_Q], max_results=300,
                              source_filters=["qa"], similarity_threshold=0.0)
    finally:
        del idx.search_deep
    dt = time.perf_counter() - t0
    log(f"sharded exact refill (Q={len(res)}, source filter 'qa', max_results 300): "
        f"search_deep calls (Q, k) {[(c[0].shape[0], c[1]) for c in calls]}, {dt:.1f} s "
        f"(single-device exact refill at Q=256, phase 4b': {single_s:.1f} s); matches "
        f"returned per "
        f"query {min(len(r.documents) for r in res)}..{max(len(r.documents) for r in res)}")
    if not any(q.shape[0] == SHARDED_REFILL_Q and k >= 16384 for q, k, _ in calls):
        raise AssertionError("the filtered batch did not reach search_deep at k = 16,384")
    for q, k, (v, g) in calls:
        ev, eg = sharded_exact(idx, torch.as_tensor(q, device=idx.device), k)
        if not (np.array_equal(g, eg.cpu().numpy()) and np.array_equal(v, ev.cpu().numpy())):
            raise AssertionError(f"search_deep at Q={q.shape[0]}, k={k}: ids or scores "
                                 f"differ from the exact reference")
    log(f"  every search_deep call's ids and scores equal the exact reference's")
    return dt


def sharded_phase(work, storage, kernels, know, questions, passages, r_ivf, refill_s,
                  device="cuda"):
    """Phase 4e: ``RAGEngine`` over a ``ShardedIndex`` of 4 shards on the
    one card (``index_devices=[cuda:0] * 4``): (i) the 1,939 text rows
    (int8 single-pass per shard); (ii) phase 4's 5,636,096-row snapshot
    restored with ``tier="auto"`` (the ivf tier, warm-started per shard
    with an int8 fine copy; the k = 100 batch exact per shard; the
    filtered deep refill; a cold rebuild); (iii) the same snapshot in a
    2 x 2 hierarchical layout with ``tier="int8"`` (two-pass per shard).
    Each engine is freed before the next: the master alone is 25.8 GB."""
    import torch

    from modular_rag_system_tpu_torch import RAGConfig, create_engine
    from modular_rag_system_tpu_torch.ops import kmeans as KM
    from modular_rag_system_tpu_torch.parallel.sharded import ShardedIndex
    from modular_rag_system_tpu_torch.types import Document

    devs = [torch.device(device)] * SHARDS
    shard_launches = {}

    def free(eng):
        eng.shutdown()
        gc.collect()
        torch.cuda.empty_cache()

    # ---- 4e-i: the text rows, cap_s 1,024 per shard
    cfg = RAGConfig.load(overrides={"index.tier": "auto", "mesh.index_shards": SHARDS,
                                    "store.storage_path": str(work / "sharded_small")})
    eng = create_engine(cfg, device=device, index_devices=devs)
    eng.add_documents([Document(content=t, source="knowledge") for t in know])
    for p in passages:
        eng.add_text(p, source="qa")
    idx = eng.index
    if not isinstance(idx, ShardedIndex) or idx.S != SHARDS or idx.cap_s != 1024:
        raise AssertionError(f"expected 4 shards of 1,024 rows, got {idx.capacity}")
    shard_launches["fused_topk_int8"] = drive_shards(
        kernels, "sharded single-pass (4 shards)", "fused_topk_int8",
        lambda: (eng.query_batch(questions[:256], similarity_threshold=0.0),
                 eng.query(questions[0], similarity_threshold=0.0)), 2)
    rec = check_sharded(eng, eng.embed_queries(questions[:256]), 10, 1e-5,
                        f"sharded single-pass route ({idx.count} rows, 4 shards)")
    if rec != 1.0:
        raise AssertionError(f"sharded single-pass recall@10 {rec} != 1.0")
    stages = query_breakdown(eng, questions, "sharded single-pass route (4 shards)")
    free(eng)
    del eng, idx

    # ---- 4e-ii: the 5,636,096-row snapshot, tier auto (ivf)
    torch.cuda.reset_peak_memory_stats()
    over = {"index.tier": "auto", "mesh.index_shards": SHARDS, "store.storage_path": storage,
            "store.snapshot_on_shutdown": False}
    t0 = time.perf_counter()
    eng = create_engine(RAGConfig.load(overrides=over), device=device, index_devices=devs)
    idx, iv = eng.index, eng.index._ivf2
    log(f"sharded restore ({SHARDS} shards) from the {REBUILD_ROWS}-row snapshot: "
        f"{time.perf_counter() - t0:.1f} s (ivf build {idx.ivf_last_build_s:.1f} s), cap_s "
        f"{idx.cap_s}; ivf stats {eng.get_system_stats()['index']['ivf']}")
    if (idx.count != REBUILD_ROWS or iv is None or not iv.warm_started
            or iv.fine_dtype != "int8" or iv.built != REBUILD_ROWS):
        raise AssertionError("the sharded restore did not warm-start an int8 ivf build")
    q256 = eng.embed_queries(questions[:256])
    shard_launches["fine_scores"] = drive_shards(
        kernels, "sharded ivf (int8, 4 shards)", "fine_scores",
        lambda: (eng.query_batch(questions[:256], similarity_threshold=0.0),
                 eng.query(questions[0], similarity_threshold=0.0)), 2)
    rec = check_sharded(eng, q256, 10, 1e-5, "sharded ivf route (int8 fine copy)")
    if rec < 0.9:
        raise AssertionError(f"sharded ivf recall@10 {rec} below the 0.9 floor")
    r_sh = gold_recall(eng, questions, passages)
    log(f"sharded ivf route: gold recall@10 {r_sh:.4f} (single-device ivf route {r_ivf:.4f})")
    if abs(r_sh - r_ivf) > 0.05:
        raise AssertionError(f"sharded gold recall {r_sh} vs the single-device {r_ivf}")
    lat1, qps = query_timings(eng, questions)
    query_breakdown(eng, questions, "sharded ivf route (4 shards)")
    log(f"sharded ivf route at {idx.count} rows: Q=1 latency {lat1:.2f} ms, Q=256 "
        f"{qps:.1f} QPS")
    # k = 2 x 50 > 64: exact per shard, no kernel
    kernels.reset_launches()
    eng.query_batch(questions[:256], max_results=50, similarity_threshold=0.0)
    if any(kernels.launches.values()):
        raise AssertionError(f"the k = 100 batch launched {dict(kernels.launches)}")
    log("route sharded ivf k=100 (exact per shard): no kernel launched")
    check_sharded(eng, q256, 100, 1e-5, "sharded k=100 route", equal=True)
    sharded_refill(eng, questions, refill_s)
    # a cold rebuild: global k-means over the shards, then the fills
    km_s, raw = [], KM.kmeans_fit_sharded

    def timed(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = raw(*a, **kw)
        torch.cuda.synchronize()
        km_s.append(time.perf_counter() - t)
        return out

    KM.kmeans_fit_sharded = timed
    try:
        idx.build_ann()
    finally:
        KM.kmeans_fit_sharded = raw
    iv = idx._ivf2
    log(f"sharded cold build: kmeans_fit_sharded {sum(km_s):.2f} s ({len(km_s)} calls: "
        f"{idx.ivf_iters} iterations, then 3 a balance round), whole build "
        f"{idx.ivf_last_build_s:.2f} s; {iv.n_clusters} clusters, int8 fine copy "
        f"{iv.fine_bytes() / 1e9:.2f} GB")
    if iv.warm_started or not km_s:
        raise AssertionError("the cold build did not run k-means")
    drive_shards(kernels, "sharded ivf after the cold build", "fine_scores",
                 lambda: eng.query_batch(questions[:256], similarity_threshold=0.0), 1)
    rec = check_sharded(eng, q256, 10, 1e-5, "sharded ivf route (cold build)")
    if rec < 0.9:
        raise AssertionError(f"sharded ivf recall@10 after the cold build {rec} < 0.9")
    log(f"peak device memory in 4e-ii {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    free(eng)
    del eng, idx, iv

    # ---- 4e-iii: 2 x 2 hierarchical, tier int8 (two-pass per shard)
    over = {**over, "index.tier": "int8", "mesh.dcn_slices": 2}
    t0 = time.perf_counter()
    eng = create_engine(RAGConfig.load(overrides=over), device=device, index_devices=devs)
    idx = eng.index
    log(f"sharded restore, 2 x 2 layout, tier int8: {time.perf_counter() - t0:.1f} s, cap_s "
        f"{idx.cap_s}")
    cap_s = 1 << ((REBUILD_ROWS + SHARDS - 1) // SHARDS - 1).bit_length()  # 2,097,152
    if not idx.hierarchical or idx.cap_s != cap_s:
        raise AssertionError("expected a 2 x 2 layout of 2,097,152-row shards")
    shard_launches["binmax_int8"] = drive_shards(
        kernels, "sharded two-pass (2 x 2)", "binmax_int8",
        lambda: (eng.query_batch(questions[:256], similarity_threshold=0.0),
                 eng.query(questions[0], similarity_threshold=0.0)), 2)
    rec = check_sharded(eng, eng.embed_queries(questions[:256]), 10, 1e-5,
                        "sharded two-pass route (2 x 2)")
    if rec != 1.0:
        raise AssertionError(f"sharded two-pass recall@10 {rec} != 1.0")
    query_breakdown(eng, questions, "sharded two-pass route (2 x 2)")
    lat1, qps = query_timings(eng, questions)
    log(f"sharded two-pass route (2 x 2) at {idx.count} rows: Q=1 latency {lat1:.2f} ms, "
        f"Q=256 {qps:.1f} QPS")
    free(eng)
    return shard_launches, stages


# phase 5: the entry points
HTTP_CLIENTS = 16
# where two runs of the same questions embed them in batches of other
# shapes (HTTP flushes against one query_batch call; ingest against
# reembed_all), the bf16 dense forward may round otherwise: a unit dense
# embedding can move by about one bf16 step at its scale (2^-7), the
# dense cosine by twice that, and the dense half weighs 1 - 0.8 = 0.2 of
# the hybrid score.  Similarities are held within this, and ids may
# differ only where the two similarities at that rank are this close.
BATCH_SHAPE_TOL = 0.2 * 2 * 2.0**-7


# the load generator: HTTP_CLIENTS client threads in a process of their
# own, so the clients' Python does not hold the server's interpreter lock.
# Reads {"base", "questions", "query", "clients"} on stdin, writes per
# question its (ids, similarities), latency (ms) and the engine time of
# the flush that answered it (the body's retrieval_time, ms), the wall
# time (s) and any errors as JSON.
_HTTP_CLIENT = r"""
import json, sys, threading, time, urllib.request
spec = json.load(sys.stdin)
qs, nc = spec["questions"], spec["clients"]
n = len(qs)
got, lat, eng, errors = [None] * n, [0.0] * n, [0.0] * n, []

def client(ci):
    try:
        for i in range(ci, n, nc):
            data = json.dumps({"query": qs[i], **spec["query"]}).encode()
            req = urllib.request.Request(spec["base"] + "/query", data=data,
                                         headers={"Content-Type": "application/json"})
            t = time.perf_counter()
            with urllib.request.urlopen(req, timeout=300) as r:
                body = json.loads(r.read())
            lat[i] = (time.perf_counter() - t) * 1e3
            eng[i] = body["retrieval_time"] * 1e3
            got[i] = [[x["id"] for x in body["results"]],
                      [x["similarity"] for x in body["results"]]]
    except Exception as exc:
        errors.append(repr(exc))

threads = [threading.Thread(target=client, args=(c,)) for c in range(nc)]
t0 = time.perf_counter()
for t in threads:
    t.start()
for t in threads:
    t.join()
json.dump({"got": got, "lat": lat, "eng": eng, "wall": time.perf_counter() - t0,
           "errors": errors}, sys.stdout)
"""


def http_json(base, path, payload=None, timeout=300):
    """(status, JSON body) of one request to the query server."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def route_only(kernels, name, expect, fn):
    """``drive`` a route, then hold that no kernel outside it launched."""
    n = drive(kernels, name, expect, fn)
    other = {k: c for k, c in kernels.launches.items() if c and k != expect}
    if other:
        raise AssertionError(f"route {name} launched kernels outside it: {other}")
    return n


def hold_near_ties(got, ref, tol, what):
    """``got`` and ``ref``: per query (ids, similarities).  Ids equal
    except at near-ties: at every rank the two similarities are within
    ``tol``, so a rank whose ids differ holds two documents that tie
    within it.  Returns (lists that differ, largest similarity gap)."""
    differ, worst = 0, 0.0
    for qi, ((gi, gs), (ri, rs)) in enumerate(zip(got, ref, strict=True)):
        if len(gi) != len(ri):
            raise AssertionError(f"{what}: query {qi} has {len(gi)} results, not {len(ri)}")
        gap = max((abs(a - b) for a, b in zip(gs, rs)), default=0.0)
        worst = max(worst, gap)
        if gap > tol:
            raise AssertionError(f"{what}: query {qi} similarities differ by {gap} > {tol}")
        differ += gi != ri
    log(f"{what}: {len(ref) - differ} of {len(ref)} id lists equal, {differ} differ at "
        f"near-ties; largest similarity gap {worst:.3g} (tolerance {tol:.3g})")
    return differ, worst


def _lists(results):
    return [([d.id for d in r.documents], list(r.similarities)) for r in results]


def entry_points(work, kernels, know, questions, passages, device="cuda"):
    """Phase 5: the port as a user starts it.  ``EnhancedRAGSystem`` on
    the card ingests the bundled corpus as uploaded files; the HTTP
    server answers the QA questions from concurrent clients through the
    query batcher (ids held against ``query_batch``); an enhanced query,
    an ``/add``, ``/health`` and ``/stats``; the lifecycle on documents
    with old timestamps (retention cleanup, compaction, re-embedding);
    and ``launcher --test`` in its own process.  Every search is the
    single-pass ``fused_topk_int8`` route.  Returns the launch counts of
    the HTTP and lifecycle runs."""
    import torch

    from modular_rag_system_tpu_torch import RAGConfig
    from modular_rag_system_tpu_torch.facade import EnhancedRAGSystem
    from modular_rag_system_tpu_torch.serving import RAGHTTPServer
    from modular_rag_system_tpu_torch.types import Document

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    storage = work / "entry"
    # the default threshold (0.7) filters nearly every hybrid score out of
    # the enhanced queries, which take it from the config
    cfg = RAGConfig.load(overrides={"index.tier": "auto", "store.storage_path": str(storage),
                                    "serving.file_server_port": 0,
                                    "serving.query_batch_window_ms": 5.0,
                                    "retrieval.similarity_threshold": 0.3})
    system = EnhancedRAGSystem(cfg, device=device, enable_llm=False)
    server = None
    try:
        system.start()
        eng = system.engine
        if eng.index.dim != D or str(eng.device) != device:
            raise AssertionError(f"expected the 768-wide index on {device}: "
                                 f"{eng.index.dim} on {eng.device}")
        # ---- uploads: the bundled corpus as text files
        src = work / "entry_files"
        src.mkdir()
        (src / "knowledge.txt").write_text("\n\n".join(know))
        for i, p in enumerate(passages):
            (src / f"qa_passage_{i:03d}.txt").write_text(p)
        t0 = time.perf_counter()
        for f in sorted(src.iterdir()):
            if system.add_file_from_path(str(f)) is None:
                raise AssertionError(f"upload of {f} failed")
        sync()
        dt = time.perf_counter() - t0
        rows = eng.index.count
        log(f"entry points: {len(passages) + 1} files uploaded and ingested, {rows} rows "
            f"in {dt:.2f} s ({rows / dt:.1f} rows/s), capacity {eng.index.capacity}, "
            f"file server on :{system.files.port}")
        if eng.index.capacity != 4096 or eng.index.effective_tier() != "int8":
            raise AssertionError("the facade's index should be int8 at capacity 4096")

        # ---- HTTP: non-enhanced queries from concurrent clients
        server = RAGHTTPServer(system, port=0)
        base = f"http://127.0.0.1:{server.start()}"
        k, thr = 10, 0.0
        n = len(questions)
        query = {"enhanced": False, "max_results": k, "similarity_threshold": thr}
        http = {}

        def http_run():
            """The questions from HTTP_CLIENTS clients in another process:
            per question its (ids, similarities) and latency, into ``http``."""
            flushes0 = server.batcher.stats["flushes"]
            spec = {"base": base, "questions": questions, "query": query,
                    "clients": HTTP_CLIENTS}
            out = subprocess.run([sys.executable, "-c", _HTTP_CLIENT], input=json.dumps(spec),
                                 capture_output=True, text=True, timeout=600)
            res = json.loads(out.stdout) if out.returncode == 0 else {}
            if out.returncode != 0 or res["errors"]:
                raise AssertionError(f"HTTP clients failed: {res.get('errors', [])[:3]} "
                                     f"{out.stderr[-2000:]}")
            http.update(got=[tuple(g) for g in res["got"]], lat=sorted(res["lat"]),
                        eng=sorted(res["eng"]), wall=res["wall"],
                        flushes=server.batcher.stats["flushes"] - flushes0)

        def pct(xs):
            return f"p50 {xs[n // 2]:.2f} ms, p99 {xs[min(n - 1, int(n * 0.99))]:.2f} ms"


        http_json(base, "/query", {"query": questions[0], **query})  # warm-up
        n_http = route_only(kernels, f"entry points: HTTP /query x{n} from {HTTP_CLIENTS} "
                            "clients (query batcher)", "fused_topk_int8", http_run)
        wall, flushes = http["wall"], http["flushes"]
        log(f"entry points: HTTP {n} requests in {wall:.2f} s: {n / wall:.1f} requests/s, "
            f"latency {pct(http['lat'])}; engine time of the answering flush "
            f"{pct(http['eng'])}; {flushes} batcher flushes (largest "
            f"{server.batcher.stats['max_flush']})")
        if not flushes < n:
            raise AssertionError(f"{flushes} flushes for {n} requests: nothing coalesced")
        ref = _lists(eng.query_batch(questions, max_results=k, similarity_threshold=thr))
        hold_near_ties(http["got"], ref, BATCH_SHAPE_TOL, "HTTP /query against query_batch")
        # the same questions again: a second sample of the spread
        http_run()
        log(f"entry points: the same {n} requests again: {n / http['wall']:.1f} requests/s, "
            f"latency {pct(http['lat'])}; engine time {pct(http['eng'])}; "
            f"{http['flushes']} flushes")
        if device != "cpu":
            # the same load again under the profiler: the device's idle share
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                http_run()
                sync()
            busy = device_busy_ms(prof)
            log(f"entry points: the same {n} requests under the profiler: wall "
                f"{http['wall'] * 1e3:.1f} ms, device busy {busy:.2f} ms, device idle "
                f"share {1 - busy / (http['wall'] * 1e3):.4f}")
        # one client, nothing to coalesce: a request's time beside the
        # engine call it makes
        one_http, one_eng = [], []
        for q in questions[:32]:
            t = time.perf_counter()
            http_json(base, "/query", {"query": q, **query})
            one_http.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            eng.query_batch([q], max_results=k, similarity_threshold=thr)
            sync()
            one_eng.append((time.perf_counter() - t) * 1e3)
        log(f"entry points: one client, 32 requests: HTTP /query median "
            f"{statistics.median(one_http):.2f} ms, engine.query_batch of the same one "
            f"question median {statistics.median(one_eng):.2f} ms (the difference: HTTP, "
            f"JSON and the batcher's 5 ms window)")

        # ---- an enhanced query, an /add, /health and /stats
        code, body = http_json(base, "/query", {"query": questions[1]})
        if code != 200 or not body.get("sources") or "insight" not in body:
            raise AssertionError(f"enhanced /query: {code} {str(body)[:300]}")
        code, body = http_json(base, "/add", {"content": "The smoke test adds this note "
                                              "through the HTTP API.", "source": "api"})
        if code != 200 or body.get("chunks") != 1:
            raise AssertionError(f"/add: {code} {body}")
        code, health = http_json(base, "/health")
        if code != 200 or health != {"status": "ok", "docs": rows + 1, "tier": "auto"}:
            raise AssertionError(f"/health: {code} {health}")
        # the warm-up, two or three rounds of the questions, the one client
        served = 1 + n * (3 if device != "cpu" else 2) + 32
        code, stats = http_json(base, "/stats")
        if (code != 200 or stats["engine"]["index"]["count"] != rows + 1
                or stats["engine"]["index"]["device"] != device
                or stats["query_batcher"]["queries"] != served):
            raise AssertionError(f"/stats: {code} {str(stats)[:500]}")
        log(f"entry points: enhanced /query, /add, /health, /stats answered; "
            f"batcher {stats['query_batcher']}")

        # ---- the lifecycle, on documents with old timestamps
        now = time.time()
        eng.add_documents([Document(content=f"An archived copy: {p}", source="archive",
                                    timestamp=now - 40 * 86400.0) for p in passages[:200]])
        life = {}

        def lifecycle():
            before = eng.query_batch(questions, max_results=k, similarity_threshold=thr)
            life["archived hits"] = sum(d.source == "archive" for r in before
                                        for d in r.documents)
            life["deleted"] = eng.cleanup_old_documents(30.0)
            cleaned = eng.query_batch(questions, max_results=k, similarity_threshold=thr)
            if any(d.source == "archive" for r in cleaned for d in r.documents):
                raise AssertionError("a deleted document is still among the results")
            live = [d.id for _r, d in eng.store.iter_all()]
            t = time.perf_counter()
            life["reclaimed"] = eng.compact()
            sync()
            life["compact s"] = time.perf_counter() - t
            if [d.id for _r, d in eng.store.iter_all()] != live:
                raise AssertionError("compact changed the surviving documents or their order")
            if eng.index.count != len(live) or eng.store.max_row() != len(live) - 1:
                raise AssertionError("compact left rows that are not dense")
            compacted = _lists(eng.query_batch(questions, max_results=k,
                                               similarity_threshold=thr))
            # the same embeddings, re-added: the same answers (the recency
            # blend moves every similarity by < 1e-6 in the seconds between)
            hold_near_ties(compacted, _lists(cleaned), 1e-5, "after compact")
            if [c[0] for c in compacted] != [c[0] for c in _lists(cleaned)]:
                raise AssertionError("ids changed across compact")
            t = time.perf_counter()
            life["reembedded"] = eng.reembed_all()
            sync()
            life["reembed s"] = time.perf_counter() - t
            again = _lists(eng.query_batch(questions, max_results=k, similarity_threshold=thr))
            life["reembed differ"], life["reembed gap"] = hold_near_ties(
                again, compacted, BATCH_SHAPE_TOL, "after reembed_all")
            life["live"] = len(live)

        n_life = route_only(kernels, "entry points: lifecycle (cleanup, compact, reembed_all, "
                            "queries)", "fused_topk_int8", lifecycle)
        log(f"entry points: lifecycle {life}")
        if life["archived hits"] == 0 or life["deleted"] != 200 or life["reclaimed"] != 200:
            raise AssertionError(f"lifecycle: {life}")
        if life["reembedded"] != life["live"] or eng.index.capacity != 4096:
            raise AssertionError(f"reembed_all: {life}")
    finally:
        if server is not None:
            server.stop()
        system.shutdown()

    # ---- the launcher in its own process (int8 tier: the kernel's route)
    cmd = [sys.executable, "-m", "modular_rag_system_tpu_torch.launcher", "--test",
           "--storage", str(work / "launcher"), "--tier", "int8", "--port", "0",
           "--device", device]
    t0 = time.perf_counter()
    out = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    for line in (out.stdout + out.stderr).strip().splitlines()[-12:]:
        log(f"  launcher: {line}")
    if out.returncode != 0 or "self-test: PASSED" not in out.stdout:
        raise AssertionError(f"launcher --test exited {out.returncode}")
    log(f"entry points: launcher --test exited 0 in {time.perf_counter() - t0:.1f} s")
    return {"http": n_http, "lifecycle": n_life}


# ---------------------------------------------------------------------------
# phase 6: the trainer on the card
TRAIN_BATCH = 256  # (query, passage) pairs a step, from the 316 QA items
TRAIN_STEPS = 30
TRAIN_LR = 1e-4
TRAIN_WARM = 5  # steps left out of the median step time
# step 0 on the card against the same batch on the host CPU from the same
# weights, both bf16: the sums run in other orders (cuBLAS against
# oneDNN), which moves a unit embedding by about a bf16 step and a
# logit (cosine / 0.05) by ~0.02; the mean loss moves far less, and an
# argmax may flip only at a near-tie
STEP0_LOSS_TOL = 2e-2
STEP0_ACC_TOL = 2 / TRAIN_BATCH
FEEDBACK_PAIRS = 64
FEEDBACK_STEPS = 20
TOOL_STEPS = 20  # build_default_encoder's training steps (its --smoke run)


def train_flops(arch: dict, batch: int, seq_len: int) -> int:
    """Matmul FLOPs of one training step (forward and backward over 2 x
    ``batch`` sequences of ``seq_len`` tokens): 6 per Dense weight and
    token, and the attention products (QK^T and PV: 4 L^2 d a sequence
    and layer forward, 3x that with the backward).  Embedding gathers,
    LayerNorms, softmax and the B x B logits are left out (under 1% at
    the bundled encoder's widths)."""
    h, m, n_layers = arch["hidden"], arch["mlp_dim"], arch["num_layers"]
    dense_weights = n_layers * (4 * h * h + 2 * h * m)
    attention = n_layers * 2 * batch * 4 * seq_len * seq_len * h
    return 6 * dense_weights * 2 * batch * seq_len + 3 * attention


def check_clip_adamw(trainer, grad, spec):
    """clip_adamw at the trainer's flat size and split, on one step's real
    gradient ``grad`` (flat) and the trainer's masters and moments (as
    copies): with the clip at twice and at half the gradient's norm, the
    kernel's norm and p, mu and nu held against the plain version within
    1e-6 relative (values: of |ref| plus the buffer's largest |ref|, as
    the card tests hold them), and two kernel runs equal bit for bit;
    then each entry point timed alone and the pair through the wrapper.
    Bound: bytes, the norm's read of g (4 B an element) and the apply's
    read of p, g, mu, nu and write of p, mu, nu (28 B).  Returns the two
    entries' kernel-report fields."""
    import torch

    from modular_rag_system_tpu_torch import kernels
    from modular_rag_system_tpu_torch.ops import clip_adamw as CA

    n, split = trainer.flat_params.numel(), trainer.split_numel
    state = (trainer.flat_params, trainer.flat_mu, trainer.flat_nu)
    gnorm = float(torch.linalg.vector_norm(grad))
    lr, count = trainer._lr(trainer.step_count), trainer.step_count + 1
    errs = {"clip_adamw_norm": 0.0, "clip_adamw_apply": 0.0}
    for clipped, clip in ((False, 2.0 * gnorm), (True, 0.5 * gnorm)):
        h = CA.adamw_scalars(lr, count, trainer.weight_decay, clip)
        runs = [[t.clone() for t in state] for _ in range(2)]
        plain = [t.clone() for t in state]
        nk = [CA.clip_adamw(b[0], grad, b[1], b[2], split, h) for b in runs]
        nr = CA.clip_adamw_reference(plain[0], grad, plain[1], plain[2], split, h)
        torch.cuda.synchronize()
        what = f"clip_adamw ({'clipped' if clipped else 'unclipped'}, n {n:,}, split {split:,})"
        if (nr.item() >= clip) != clipped:
            raise AssertionError(f"{what}: norm {nr.item()} against clip {clip}")
        d = abs(nk[0].item() - nr.item())
        errs["clip_adamw_norm"] = max(errs["clip_adamw_norm"], d)
        if d > 1e-6 * nr.item():
            raise AssertionError(f"{what}: norm {nk[0].item()} against plain {nr.item()}")
        for name, a, b in zip(("p", "mu", "nu"), runs[0], plain):
            diff = (a - b).abs()
            errs["clip_adamw_apply"] = max(errs["clip_adamw_apply"], diff.max().item())
            if (diff > 1e-6 * (b.abs() + b.abs().max())).any():
                raise AssertionError(f"{what}: {name} max |d| {diff.max().item():.3e}")
        if nk[0].item() != nk[1].item() or not all(
                torch.equal(a, b) for a, b in zip(*runs)):
            raise AssertionError(f"{what}: two runs on the same inputs differ")
    p, mu, nu = (t.clone() for t in state)
    partials = torch.empty(2 * CA.GRID, dtype=torch.float32, device=grad.device)
    stream = torch.cuda.current_stream().cuda_stream
    norm_ms = cuda_ms(lambda: kernels.launch("clip_adamw_norm", grad.data_ptr(), n, split,
                                             CA.GRID, partials.data_ptr(), stream))
    apply_ms = cuda_ms(lambda: kernels.launch(
        "clip_adamw_apply", p.data_ptr(), grad.data_ptr(), mu.data_ptr(), nu.data_ptr(), n,
        partials.data_ptr(), CA.GRID, None, None, *h, stream))
    pair_ms = cuda_ms(lambda: CA.clip_adamw(p, grad, mu, nu, split, h))
    pair_queued = queued_ms(lambda: CA.clip_adamw(p, grad, mu, nu, split, h))
    norm_b, _ = bound(4 * n, 0, 1.0, spec)
    apply_b, _ = bound(28 * n, 0, 1.0, spec)
    pair_b, _ = bound(32 * n, 0, 1.0, spec)
    log(f"clip_adamw at the trainer's {n:,} f32 parameters (split {split:,}), one step's "
        f"gradient (norm {gnorm:.4f}), clipped and unclipped: max |err| vs plain: norm "
        f"{errs['clip_adamw_norm']:.2e}, p/mu/nu {errs['clip_adamw_apply']:.2e}; bit-equal "
        f"on repeat; clip_adamw_norm {norm_ms:.4f} ms (bound {norm_b:.4f}, bytes), "
        f"clip_adamw_apply {apply_ms:.4f} ms (bound {apply_b:.4f}, bytes); the pair "
        f"through the wrapper {pair_ms:.4f} ms (queued {pair_queued:.4f}; bound "
        f"{pair_b:.4f}, {32 * n / 1e6:.0f} MB)")
    pair = {"pair_ms": pair_ms, "pair_queued_ms": pair_queued, "pair_bound_ms": pair_b}
    return {"clip_adamw_norm": {"max_abs_err": errs["clip_adamw_norm"], "ms": norm_ms,
                                "bound_ms": norm_b, "bound_by": "bytes", **pair},
            "clip_adamw_apply": {"max_abs_err": errs["clip_adamw_apply"], "ms": apply_ms,
                                 "bound_ms": apply_b, "bound_by": "bytes", **pair}}


def train_phase(work, kernels, know, questions, passages, spec, device="cuda"):
    """Phase 6: the contrastive trainer on the card at the bundled
    encoder's full width (4 layers, hidden 384, 12 heads, FFN 1536, vocab
    16384, L = 128, bf16 compute over f32 masters), batches of
    ``TRAIN_BATCH`` QA pairs: step 0 against the host CPU's loss of the
    same batch, ``TRAIN_STEPS`` steps (the loss falls; step time, tokens/s,
    peak memory, the bound, the device's idle share), a checkpoint round
    trip; then ``fine_tune_from_feedback`` through ``EnhancedRAGSystem``
    (the serving encoder changes to the trainer's weights, every live row
    is re-embedded, and the questions run ``fused_topk_int8`` alone with
    ids equal to the exact tier's); and the ``build_default_encoder``
    tool in a process of its own, whose asset must load and encode.
    Returns the kernel launches of the query run after the fine-tune."""
    import random

    import torch

    from modular_rag_system_tpu_torch import RAGConfig
    from modular_rag_system_tpu_torch.facade import EnhancedRAGSystem
    from modular_rag_system_tpu_torch.models.default_ckpt import (
        build_default_encoder,
        load_default_assets,
    )
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer

    cuda = device != "cpu"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    if cuda:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    _, arch, _ = load_default_assets()
    enc = build_default_encoder(RAGConfig(), device)  # the bundled dense half
    L = enc.max_seq_len
    order = list(range(len(questions)))
    random.Random(0).shuffle(order)

    def batch(s):
        rows = [order[(s * TRAIN_BATCH + i) % len(order)] for i in range(TRAIN_BATCH)]
        return [questions[i] for i in rows], [passages[i] for i in rows]

    # ---- step 0 against the host CPU, same batch, same weights
    t0 = time.perf_counter()
    ref_loss, ref_acc = ContrastiveTrainer(build_default_encoder(RAGConfig(), "cpu")
                                           ).evaluate(*batch(0))
    log(f"train: CPU reference of step 0 ({TRAIN_BATCH} pairs, L = {L}, bf16) in "
        f"{time.perf_counter() - t0:.1f} s: loss {ref_loss:.5f}, acc {ref_acc:.4f}")
    trainer = ContrastiveTrainer(enc, learning_rate=TRAIN_LR)
    losses, step_ms = [], []
    update_kernels = ("clip_adamw_norm", "clip_adamw_apply")
    before = {k: kernels.launches[k] for k in update_kernels}
    for s in range(TRAIN_STEPS):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        loss, acc = trainer.step(*batch(s))
        if cuda:
            end.record()
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        losses.append(loss)
        if s == 0:
            log(f"train: step 0 on {device}: loss {loss:.5f} (CPU {ref_loss:.5f}, "
                f"|diff| {abs(loss - ref_loss):.2e}, tolerance {STEP0_LOSS_TOL}), acc "
                f"{acc:.4f} (CPU {ref_acc:.4f})")
            if abs(loss - ref_loss) > STEP0_LOSS_TOL or abs(acc - ref_acc) > STEP0_ACC_TOL:
                raise AssertionError("train: step 0 on the card disagrees with the CPU")
    last = statistics.mean(losses[-5:])
    log(f"train: losses {[round(x, 4) for x in losses]}")
    if not all(map(math.isfinite, losses)) or not last < losses[0]:
        raise AssertionError(f"train: the loss did not fall: {losses[0]} -> mean {last}")
    out = {"losses": (losses[0], last)}
    if cuda:
        # the update: the flat gradient and clip_adamw's two launches a step
        out["update_launches"] = {k: kernels.launches[k] - before[k] for k in update_kernels}
        if any(n != TRAIN_STEPS for n in out["update_launches"].values()):
            raise AssertionError(f"train: {TRAIN_STEPS} steps launched "
                                 f"{out['update_launches']}")
        # the kernel against its plain version on a real step's gradient
        loss, _ = trainer._loss(*batch(TRAIN_STEPS + 3))
        grad = trainer._flat_grad(dict(zip(trainer.params, torch.autograd.grad(
            loss, list(trainer.params.values())))))
        del loss
        out["update_kernels"] = check_clip_adamw(trainer, grad, spec)
        del grad
        tokens = 2 * TRAIN_BATCH * L
        med = statistics.median(step_ms[TRAIN_WARM:])
        flops = train_flops(arch, TRAIN_BATCH, L)
        n_params = sum(p.numel() for p in trainer.params.values())
        # each input read once, each output written once: ids and masks,
        # the f32 masters and both moments in, all three out
        nbytes = 2 * 2 * TRAIN_BATCH * L * 8 + 6 * 4 * n_params
        bound_ms, bound_by = bound(nbytes, flops, spec[2], spec)
        from modular_rag_system_tpu_torch.models.tokenizer import WordPieceTokenizer

        py_tok = WordPieceTokenizer(enc.tokenizer.vocab, enc.max_seq_len, use_native=False)
        tok_ms = {}
        for name, tok in (("native", enc.tokenizer), ("Python", py_tok)):
            t = time.perf_counter()
            for _ in range(3):
                tok.encode_batch(batch(1)[0] + batch(1)[1])
            tok_ms[name] = (time.perf_counter() - t) / 3 * 1e3
        if enc.tokenizer._wp_native is None:
            raise AssertionError("train: the tokenizer did not take the native engine")
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            trainer.step(*batch(TRAIN_STEPS))
            sync()
            wall = (time.perf_counter() - t) * 1e3
        busy = device_busy_ms(prof)
        # another step with the host ops recorded: device time by the op
        # that launched it (aten::mm, aten::mul, ...), not by kernel name
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof_ops:
            trainer.step(*batch(TRAIN_STEPS + 1))
            sync()
        ops = sorted(((e.key, e.count, e.self_device_time_total / 1e3)
                      for e in prof_ops.key_averages()
                      if e.device_type == DeviceType.CPU and e.self_device_time_total > 0),
                     key=lambda op: -op[2])
        log(f"train: device time of a step by op, top 10 of {len(ops)} (sum "
            f"{sum(op[2] for op in ops):.2f} ms): " + "; ".join(
                f"{op} x{n} {ms:.2f} ms" for op, n, ms in ops[:10]))
        log(f"train: step time median {med:.2f} ms over steps {TRAIN_WARM}-{TRAIN_STEPS - 1} "
            f"(CUDA events around trainer.step; min {min(step_ms[TRAIN_WARM:]):.2f}, max "
            f"{max(step_ms[TRAIN_WARM:]):.2f}), {tokens / med * 1e3:,.0f} tokens/s "
            f"({tokens} a step); bound {bound_ms:.3f} ms ({bound_by}: {flops / 1e12:.3f} "
            f"TFLOP a step at {spec[2] / 1e12:.0f} TFLOP/s, {nbytes / 1e6:.0f} MB), "
            f"{bound_ms / med:.3f} of it; host tokenization {tok_ms['native']:.2f} ms a step "
            f"(native engine; the Python path {tok_ms['Python']:.2f} ms); one "
            f"profiled step: wall {wall:.2f} ms, device busy {busy:.2f} ms, idle share "
            f"{1 - busy / wall:.3f}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; {n_params:,} parameters")
        out.update(step_ms=med, bound_ms=bound_ms, busy_ms=busy, wall_ms=wall)

    # ---- checkpoint round trip: the restored trainer takes the same step
    ckpt = work / "trainer.pt"
    trainer.save_checkpoint(str(ckpt))
    twin = ContrastiveTrainer(build_default_encoder(RAGConfig(), device), learning_rate=TRAIN_LR)
    twin.restore_checkpoint(str(ckpt))
    la, _ = trainer.step(*batch(TRAIN_STEPS + 2))
    lb, _ = twin.step(*batch(TRAIN_STEPS + 2))
    gap = max((trainer.params[k] - twin.params[k]).abs().max().item() for k in trainer.params)
    log(f"train: checkpoint round trip ({ckpt.stat().st_size / 1e6:.1f} MB): next-step loss "
        f"{la:.6f} / {lb:.6f}, parameters after it within {gap:.2e}")
    # the same weights and batch give the same loss; after the update an
    # element can differ by at most the two Adam steps' sum (2 lr) where
    # an order-dependent gradient sum flips a near-zero gradient's sign
    if twin.step_count != trainer.step_count or abs(la - lb) > 1e-5 or gap > 2 * TRAIN_LR:
        raise AssertionError(f"train: checkpoint round trip: {la} {lb} {gap}")
    del trainer, twin, enc

    # ---- build_default_encoder, in a process of its own beside the entry point
    tool_dir = work / "built_encoder"
    tool_cmd = [sys.executable, "-m", "modular_rag_system_tpu_torch.tools.build_default_encoder",
                "--smoke", "--steps", str(TOOL_STEPS), "--device", device, "--out", str(tool_dir)]
    t_tool = time.perf_counter()
    tool = subprocess.Popen(tool_cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out["fine_tune_launches"] = fine_tune_entry(work, kernels, know, questions, passages,
                                                    order, device, out)
        tool_out, tool_err = tool.communicate(timeout=900)
    finally:
        if tool.poll() is None:
            tool.kill()
            tool.communicate()
    for line in tool_err.strip().splitlines()[-8:]:
        log(f"  tool: {line}")
    if tool.returncode != 0:
        raise AssertionError(f"build_default_encoder exited {tool.returncode}")
    res = json.loads(tool_out.strip().splitlines()[-1])
    built = build_default_encoder(RAGConfig.load(overrides={
        "embedding.bundled_checkpoint": str(tool_dir)}), device)
    e = built.encode(questions[:64])
    norms = torch.linalg.vector_norm(torch.from_numpy(e), dim=1)
    if e.shape != (64, 384) or not torch.allclose(norms, torch.ones(64), atol=1e-3):
        raise AssertionError(f"the built asset encodes {e.shape}, norms {norms[:4]}")
    log(f"train: build_default_encoder --smoke --steps {TOOL_STEPS} exited 0 after "
        f"{time.perf_counter() - t_tool:.1f} s (beside the entry point run): "
        f"{res['size_mb']} MB, held-out QA recall@10 trained "
        f"{res['heldout_qa_recall@10/trained']}, tuned lexical weight "
        f"{res['tuned_lexical_weight']}; its asset ({built.name}) encodes on {device}")
    return out


def fine_tune_entry(work, kernels, know, questions, passages, order, device, out):
    """``EnhancedRAGSystem`` on ``device`` (int8 tier, capacity 4096) with
    the corpus uploaded as phase 5 does: positive feedback on
    ``FEEDBACK_PAIRS`` QA pairs, ``fine_tune_from_feedback``, then the
    questions through ``query_batch``.  Returns ``fused_topk_int8``'s
    launches in that query run."""
    import torch

    from modular_rag_system_tpu_torch import RAGConfig
    from modular_rag_system_tpu_torch.facade import EnhancedRAGSystem

    cfg = RAGConfig.load(overrides={"index.tier": "int8", "store.storage_path":
                                    str(work / "fine_tune"), "serving.file_server_port": 0})
    system = EnhancedRAGSystem(cfg, device=device, enable_llm=False)
    try:
        eng = system.engine
        src = work / "fine_tune_files"
        src.mkdir()
        (src / "knowledge.txt").write_text("\n\n".join(know))
        for i, p in enumerate(passages):
            (src / f"qa_passage_{i:03d}.txt").write_text(p)
        for f in sorted(src.iterdir()):
            if system.add_file_from_path(str(f)) is None:
                raise AssertionError(f"upload of {f} failed")
        if eng.index.capacity != 4096 or eng.index.effective_tier() != "int8":
            raise AssertionError("the fine-tune system's index should be int8 at capacity 4096")
        dense = eng.encoder.dense
        probe = questions[:32]
        e_before = dense.encode(probe)
        r_before = gold_recall(eng, questions, passages)
        for i in order[:FEEDBACK_PAIRS]:
            system.record_feedback(questions[i], "positive", matched_content=passages[i])
        t = time.perf_counter()
        metrics = system.fine_tune_from_feedback(steps=FEEDBACK_STEPS)
        if device != "cpu":
            torch.cuda.synchronize()
        dt = time.perf_counter() - t
        live = sum(1 for _ in eng.store.iter_all())
        log(f"train: fine_tune_from_feedback({FEEDBACK_STEPS} steps, {FEEDBACK_PAIRS} pairs) "
            f"in {dt:.2f} s: {metrics}; {live} live rows")
        if metrics is None or metrics["rows_reembedded"] != live or metrics["pairs"] != \
                FEEDBACK_PAIRS or not math.isfinite(metrics["final_loss"]):
            raise AssertionError(f"fine_tune_from_feedback: {metrics}")
        # the serving encoder now runs the trainer's weights cast to bf16
        e_after = dense.encode(probe)
        moved = float(abs(e_after - e_before).max())
        ref_module = dense.make_module()
        ref_module.load_state_dict(system._trainer.params)
        ids, mask = dense._crop_seq(*dense.tokenizer.encode_batch(probe))
        with torch.inference_mode():
            ref = ref_module(torch.from_numpy(ids).to(dense.device, torch.long),
                             torch.from_numpy(mask).to(dense.device)).cpu().numpy()
        gap = float(abs(e_after - ref).max())
        log(f"train: serving embeddings moved by up to {moved:.3e}; against a module cast "
            f"from the trainer's masters within {gap:.1e}")
        if moved < 1e-3 or gap > 1e-6:
            raise AssertionError(f"the serving encoder after the fine-tune: {moved} {gap}")
        n = route_only(kernels, f"train: query_batch x{len(questions)} after the re-embedding",
                       "fused_topk_int8", lambda: eng.query_batch(
                           questions, max_results=10, similarity_threshold=0.0))
        q = eng.embed_queries(questions)
        for lo in range(0, len(questions), 256):
            rec = check_against_exact(eng, q[lo:lo + 256], 10, 1e-5,
                                      "train: the re-embedded index")
            if rec != 1.0:
                raise AssertionError(f"recall@10 {rec} against the exact tier after the fine-tune")
        r_after = gold_recall(eng, questions, passages)
        log(f"train: gold recall@10 {r_before:.4f} before the fine-tune, {r_after:.4f} after")
        out.update(fine_tune_s=dt, gold=(r_before, r_after))
        return n
    finally:
        system.shutdown()


# ---------------------------------------------------------------------------
# phase 7: an encoder from a local HF checkpoint, the native tokenizer, the
# external eval
# all-MiniLM-L6-v2's published config (its config.json), weights random
MINILM_CONFIG = {"architectures": ["BertModel"], "model_type": "bert", "vocab_size": 30522,
                 "hidden_size": 384, "num_hidden_layers": 6, "num_attention_heads": 12,
                 "intermediate_size": 1536, "max_position_embeddings": 512,
                 "hidden_act": "gelu", "hidden_dropout_prob": 0.1,
                 "attention_probs_dropout_prob": 0.1, "layer_norm_eps": 1e-12,
                 "type_vocab_size": 2, "initializer_range": 0.02, "pad_token_id": 0,
                 "position_embedding_type": "absolute"}
HF_COS_FLOOR = 0.995  # bf16 card forward against the f32 CPU forward
CPU_REF_PASSAGES = 64  # the longest passages, through the f32 CPU forward
HF_LONG_DOCS = 4  # documents long enough for the 256-token bucket


def minilm_vocab(size=None):
    """The bundled vocab's pieces padded with ``[unusedN]`` to ``size`` ids
    (all-MiniLM-L6-v2's 30,522 unless given)."""
    from modular_rag_system_tpu_torch.models.default_ckpt import ASSET_DIR
    from modular_rag_system_tpu_torch.models.tokenizer import load_vocab

    vocab = load_vocab(str(ASSET_DIR / "vocab.txt"))
    n = len(vocab)
    size = size or MINILM_CONFIG["vocab_size"]
    vocab.update({f"[unused{i}]": n + i for i in range(size - n)})
    return vocab


def native_tokenizers(questions, passages, hf_vocab, cuda):
    """The native engine is loaded; under the bundled vocab and the
    checkpoint's, the questions and passages tokenize to the same ids and
    masks natively and in Python; the tokenize stage at Q=256 both ways."""
    from modular_rag_system_tpu_torch import native
    from modular_rag_system_tpu_torch.models.default_ckpt import load_default_assets
    from modular_rag_system_tpu_torch.models.tokenizer import WordPieceTokenizer

    eng = native.get_engine()
    if eng is None:
        raise AssertionError("the native text engine did not load")
    _, arch, bundled = load_default_assets()
    times = {}
    for name, vocab, L in (("bundled", bundled, arch["max_len"]),
                           ("checkpoint", hf_vocab, MINILM_CONFIG["max_position_embeddings"])):
        L = min(L, 256)
        nat, py = WordPieceTokenizer(vocab, L), WordPieceTokenizer(vocab, L, use_native=False)
        if nat._wp_native is None:
            raise AssertionError("the WordPiece tokenizer did not take the native engine")
        for what, texts in (("questions", questions), ("passages", passages)):
            (a, am), (b, bm) = nat.encode_batch(texts), py.encode_batch(texts)
            if not ((a == b).all() and (am == bm).all()):
                raise AssertionError(f"native ids differ from Python's: {name} {what}")
        batch = questions[:256]
        t_nat = wall_ms(lambda: nat.encode_batch(batch), reps=5) if cuda else 0.0
        t_py = wall_ms(lambda: py.encode_batch(batch), reps=5) if cuda else 0.0
        p_nat = wall_ms(lambda: nat.encode_batch(passages[:256]), reps=5) if cuda else 0.0
        p_py = wall_ms(lambda: py.encode_batch(passages[:256]), reps=5) if cuda else 0.0
        log(f"native tokenizer, {name} vocab ({len(vocab)} pieces, max_len {L}): ids and "
            f"masks of {len(questions)} questions and {len(passages)} passages equal to the "
            f"Python path's; tokenize Q=256 questions native {t_nat:.2f} ms, Python "
            f"{t_py:.2f} ms; 256 passages native {p_nat:.2f} ms, Python {p_py:.2f} ms")
        times[name] = (t_nat, t_py, p_nat, p_py)
    return times


def external_eval_phase(device):
    """recall@10 of the shipped hybrid encoder on the external eval (304
    pairs) on the card and on the host CPU: equal within one pair."""
    from modular_rag_system_tpu_torch import RAGConfig
    from modular_rag_system_tpu_torch.models import build_encoder
    from modular_rag_system_tpu_torch.models import external_eval as X
    from modular_rag_system_tpu_torch.models.fake import FeatureHashEncoder

    n = len(X.load_external_qa()[1])
    t0 = time.perf_counter()
    card = build_encoder(RAGConfig(), device)
    r_card = X.recall_at_k_external(card, k=10)
    legacy = X.recall_at_k_legacy96(card, k=10)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    r_cpu = X.recall_at_k_external(build_encoder(RAGConfig(), "cpu"), k=10)
    t_cpu = time.perf_counter() - t0
    dense = X.bundled_encoder_external_recall(k=10, device=device)
    hashed = X.recall_at_k_external(FeatureHashEncoder(dim=384), k=10)
    lo, hi = X.wilson_interval(r_card, n)
    log(f"external eval ({n} pairs, k=10): {card.name} on {device} {r_card:.4f} "
        f"({round(r_card * n)}/{n}, 95% Wilson [{lo:.4f}, {hi:.4f}], {t_card:.1f} s with "
        f"legacy96), on the host CPU {r_cpu:.4f} ({round(r_cpu * n)}/{n}, {t_cpu:.1f} s); "
        f"legacy96 {legacy:.4f}; dense half only {dense:.4f}; feature-hash baseline "
        f"{hashed:.4f}; chance {10 / n:.4f}")
    if abs(r_card - r_cpu) > 1 / n + 1e-12:
        raise AssertionError(f"external recall on the card {r_card} vs the CPU {r_cpu}")
    return {"card": r_card, "cpu": r_cpu, "legacy96": legacy, "dense": dense, "hash": hashed}


def hf_phase(work, kernels, know, questions, passages, spec, step_ms=None, device="cuda"):
    """Phase 7: ``create_engine`` over an encoder read from a local HF
    checkpoint at all-MiniLM-L6-v2's published widths (6 layers, hidden
    384, 12 heads, FFN 1536, vocab 30,522, 512 positions; random weights
    from a seeded generator, written by this script), served at the
    default ``max_seq_len`` 256 in the default hybrid (index dim 768),
    tokenized by the native engine: ingest of the bundled corpus, the
    questions at Q=256 and Q=1 (``fused_topk_int8``), ids against the
    exact tier, the card's bf16 embeddings against the f32 CPU forward;
    the same checkpoint with ``attention_impl="flash"`` (``mea_attention``
    in each of the 6 layers, timed alone at B = 256, L = 256); the native
    tokenizer against the Python path; the external eval on the card and
    on the CPU.  Returns the launches and the L = 256 attention timing."""
    import torch

    from modular_rag_system_tpu_torch import RAGConfig, create_engine
    from modular_rag_system_tpu_torch.models import hf_loader as H
    from modular_rag_system_tpu_torch.types import Document

    cuda = device != "cpu"
    out = {}
    t0 = time.perf_counter()
    vocab = minilm_vocab()
    ckpt = H.save_hf_checkpoint(work / "minilm_l6_v2_widths",
                                H.random_hf_weights(MINILM_CONFIG, seed=0), MINILM_CONFIG,
                                vocab)
    size = sum(f.stat().st_size for f in ckpt.iterdir())
    log(f"hf: checkpoint at all-MiniLM-L6-v2's widths written in "
        f"{time.perf_counter() - t0:.1f} s ({size / 1e6:.1f} MB: config.json, vocab.txt "
        f"{len(vocab)} pieces, model.safetensors)")

    def config(name, **extra):
        return RAGConfig.load(overrides={"index.tier": "auto", "embedding.hf_checkpoint":
                                         str(ckpt), "store.storage_path": str(work / name),
                                         **extra})

    t0 = time.perf_counter()
    eng = create_engine(config("hf"), device=device)
    dense = eng.encoder.dense
    log(f"hf engine: {eng.encoder.name}, index dim {eng.index.dim}, built in "
        f"{time.perf_counter() - t0:.1f} s")
    if (dense.name != "minilm-l6-h384" or len(dense.module.blocks) != 6
            or dense.max_seq_len != 256 or dense.module.pos_embed.weight.shape[0] != 256
            or dense.tokenizer.name != "wordpiece" or dense.tokenizer.vocab_size != 30522
            or dense.tokenizer._wp_native is None or eng.index.dim != D):
        raise AssertionError("the HF engine is not the checkpoint's encoder on the native "
                             "tokenizer in the 768-wide hybrid")
    # every passage is under 128 tokens: four of them joined make a chunk
    # that the tokenizer cuts at 256, the longest bucket
    long_docs = [" ".join(passages[i:i + 4]) for i in range(0, 4 * HF_LONG_DOCS, 4)]

    def ingest(e):
        e.add_documents([Document(content=t, source="knowledge") for t in know])
        for p in passages:
            e.add_text(p, source="qa")
        for t in long_docs:
            e.add_text(t, source="long")

    t0 = time.perf_counter()
    ingest(eng)
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    log(f"hf engine ingest: {eng.index.count} rows in {dt:.2f} s "
        f"({eng.index.count / dt:.1f} rows/s), capacity {eng.index.capacity}")
    if eng.index.capacity != 4096 or eng.index.effective_tier() != "int8":
        raise AssertionError("the HF engine's index should be int8 at capacity 4096")
    if not any(d.source == "long" for d in eng.query(long_docs[0], max_results=1,
                                                      similarity_threshold=0.0).documents):
        raise AssertionError("a long document is not its own nearest row")
    out["fused_topk_int8"] = {
        "Q256": drive(kernels, "hf engine Q=256 (int8 single-pass)", "fused_topk_int8",
                      lambda: eng.query_batch(questions[:256], similarity_threshold=0.0)),
        "Q1": drive(kernels, "hf engine Q=1 (int8 single-pass)", "fused_topk_int8",
                    lambda: eng.query(questions[0], similarity_threshold=0.0))}
    q = eng.embed_queries(questions)
    for lo, hi in ((0, 256), (256, len(questions)), (0, 1)):
        rec = check_against_exact(eng, q[lo:hi], 10, 1e-5,
                                  f"hf engine, questions {lo}..{hi - 1}")
        if rec != 1.0:
            raise AssertionError(f"hf engine: recall@10 {rec} against the exact tier")

    # the card's bf16 dense half against the f32 forward on the host CPU
    longest = sorted(passages, key=len, reverse=True)[:CPU_REF_PASSAGES]
    texts = questions + longest + long_docs
    t0 = time.perf_counter()
    ref = H.try_build_pretrained_encoder(config("unused", **{"embedding.dtype": "float32"}),
                                         "cpu").encode(texts)
    t_ref = time.perf_counter() - t0
    got = dense.encode(texts)
    cos = (got * ref).sum(1)
    buckets = sorted({dense._crop_seq(*dense.tokenizer.encode_batch([t]))[0].shape[1]
                      for t in texts})
    log(f"hf encoder on {device} (bf16) vs the f32 CPU forward ({t_ref:.1f} s) over "
        f"{len(questions)} questions, the {len(longest)} longest passages and "
        f"{len(long_docs)} long documents (sequence buckets {buckets}): min cosine {cos.min():.6f}, mean {cos.mean():.6f} (floor "
        f"{HF_COS_FLOOR})")
    if buckets[-1] != 256:
        raise AssertionError(f"the HF forwards reached buckets {buckets}, not 256")
    if not (got.shape == ref.shape == (len(texts), 384) and cos.min() >= HF_COS_FLOOR):
        raise AssertionError("the card's HF embeddings differ from the f32 CPU forward")
    out["gold"] = gold_recall(eng, questions, passages)
    if cuda:
        out["lat1"], out["qps"] = query_timings(eng, questions)
        query_breakdown(eng, questions, "hf engine (int8 single-pass)")
        log(f"hf engine: gold recall@10 {out['gold']:.4f} (random weights), Q=1 latency "
            f"{out['lat1']:.2f} ms, Q=256 {out['qps']:.1f} QPS")
    e_dense = dense.encode_device(questions)

    # the same checkpoint with the mea_attention kernel in every layer
    flash = create_engine(config("hf_flash", **{"embedding.attention_impl": "flash"}),
                          device=device)
    fd = flash.encoder.dense
    forwards = [0]
    forward_tokens = fd.forward_tokens

    def counted(ids, mask):
        forwards[0] += 1
        return forward_tokens(ids, mask)

    fd.forward_tokens = counted

    n_ingest = drive(kernels, "hf flash engine ingest", "mea_attention", lambda: ingest(flash))
    if n_ingest != 6 * forwards[0]:
        raise AssertionError(f"{n_ingest} mea_attention launches for {forwards[0]} forwards")
    forwards[0] = 0
    n_query = run_route(flash, kernels, questions, "hf flash engine (int8 single-pass)",
                        "mea_attention")
    if n_query != 6 * forwards[0]:
        raise AssertionError(f"{n_query} mea_attention launches for {forwards[0]} forwards")
    fd.forward_tokens = forward_tokens
    e_flash = fd.encode_device(questions)
    cos = (e_flash * e_dense).sum(1)
    log(f"hf flash vs dense encoder over {len(questions)} questions (bf16): min cosine "
        f"{cos.min().item():.6f}, max |d| {(e_flash - e_dense).abs().max().item():.2e} "
        f"(floor: cosine 0.999); mea_attention launches: ingest {n_ingest}, queries {n_query}")
    if not (torch.isfinite(e_flash).all() and cos.min().item() >= 0.999):
        raise AssertionError("hf flash embeddings differ from the dense encoder's")
    out["mea_attention"] = {"ingest": n_ingest, "queries": n_query}
    flash.shutdown()
    eng.shutdown()
    del eng, flash, dense, fd
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        # the bucket a 256-token sequence of this checkpoint reaches
        g = torch.Generator(device=device).manual_seed(3)
        qkv = [torch.randn((256, 256, 12, 32), generator=g, device=device)
               .to(torch.bfloat16) for _ in range(3)]
        pad = torch.ones((256, 256), dtype=torch.int32, device=device)
        pad[0, 200:] = 0
        pad[1, 100:] = 0
        out["mea_L256"], out["mea_L256_err"] = time_mea(*qkv, pad, spec,
                                                        "alone (hf bucket, B x H = 3072)")
        del qkv
        torch.cuda.empty_cache()

    out["tokenize"] = native_tokenizers(questions, passages + long_docs, vocab, cuda)
    if step_ms is not None:
        log(f"hf: phase 6's training step (native tokenizer): {step_ms:.2f} ms median; "
            "reported, not claimed")
    out["external"] = external_eval_phase(device)
    return out


# ---------------------------------------------------------------------------
# phase 7b: ModernBERT on long documents (the window mode of mea_attention)
MODERNBERT_CONFIG = {"architectures": ["ModernBertModel"], "model_type": "modernbert",
                     "vocab_size": 50368, "hidden_size": 768, "num_hidden_layers": 22,
                     "num_attention_heads": 12, "intermediate_size": 1152,
                     "max_position_embeddings": 8192, "global_attn_every_n_layers": 3,
                     "local_attention": 128, "global_rope_theta": 160000.0,
                     "local_rope_theta": 10000.0, "norm_eps": 1e-5, "norm_bias": False,
                     "attention_bias": False, "mlp_bias": False, "hidden_activation": "gelu"}
# pieces joined into each of the batch's documents: ~340 to past 8,192
# tokens, the spread of the benchmark's long-document cell
LONGDOC_PIECES = (30, 100, 170, 240, 310, 380, 450, 520)


def modernbert_checkpoint(out_dir, config, seed=0):
    """A ModernBERT checkpoint for ``config``: the benchmark's seeded
    weights (``portbench/reference/modernbert.random_weights``: matrices
    normal with std 0.02 truncated at +-2 std, norms 1) and the bundled
    vocab padded to the config's ids."""
    from modular_rag_system_tpu_torch.models import hf_loader as H
    from portbench.reference.modernbert import random_weights

    return H.save_hf_checkpoint(out_dir, random_weights(config, seed, "cpu"), config,
                                minilm_vocab(config["vocab_size"]))


def time_mea_template(q, k, v, pad):
    """The full mode's tile template (design 0) at inputs where the
    wrapper picks the Hopper design: held against the plain version and
    timed, beside the design the wrapper picked."""
    from modular_rag_system_tpu_torch.ops import flash_attention as FA

    B_, L, H, dh = q.shape
    design = FA.full_design(L, dh, q.dtype)
    err = _check_mea(FA._launch(q, k, v, pad, 0), FA.mea_attention_reference(q, k, v, pad),
                     "mea_attention's tile template")
    ms = cuda_ms(lambda: FA._launch(q, k, v, pad, 0), reps=5)
    log(f"time mea_attention's tile template (design 0) B={B_} L={L} H={H} dh={dh}: {ms:.4f} ms "
        f"(the wrapper picks design {design}); max |err| vs plain {err:.2e}")
    return {"design": design, "template_ms": ms, "template_max_abs_err": err}


def mea_crossover(dev, lengths=(256, 512, 1024, 2048)):
    """Both full-mode designs at B = 8, H = 12, dh 64 (B x H = 96, every key
    live), bf16: where the Hopper design overtakes the tile template (the
    wrapper's LONG_FROM).  {L: {"template_ms", "hopper_ms"}}."""
    import torch

    from modular_rag_system_tpu_torch.ops import flash_attention as FA

    g = torch.Generator(device=dev).manual_seed(23)
    res = {}
    for L in lengths:
        q, k, v = (torch.randn((8, L, 12, 64), generator=g, device=dev).to(torch.bfloat16)
                   for _ in range(3))
        pad = torch.ones((8, L), device=dev)
        res[L] = {f"{name}_ms": cuda_ms(lambda: FA._launch(q, k, v, pad, d), reps=20)
                  for name, d in (("template", 0), ("hopper", 1))}
    log("mea_attention's full mode, B=8 H=12 dh=64 bf16, template / Hopper design ms: " +
        ", ".join(f"L={L} {t['template_ms']:.4f} / {t['hopper_ms']:.4f}" for L, t in res.items()) +
        f"; the wrapper takes the Hopper design from L={FA.LONG_FROM} on")
    return res


def longdoc_phase(work, kernels, know, passages, spec, device="cuda",
                  config=MODERNBERT_CONFIG, pieces=LONGDOC_PIECES):
    """Phase 7b: ``create_engine`` over a ModernBERT checkpoint at
    ModernBERT-base's published widths and depth (22 layers: 8 global, 14
    with |i - j| <= 64; seeded weights, written by this script) served at
    8,192 positions with ``attention_impl="flash"``, as the benchmark's
    ``modernbert-ingest-8k`` cell runs it: ``add_documents`` of 8 long
    documents (the longest cut at 8,192) launches ``mea_attention`` once a
    global layer and ``mea_attention_window`` once a local layer and
    forward, and nothing else; each mode is held against its plain
    version at the first global and the first local layer's own inputs of
    that batch (B 8, L 8,192, H 12, dh 64, bf16, ragged padding) and timed
    there.  Returns {entry: (timing, max |error|, launches)}."""
    import numpy as np
    import torch

    from modular_rag_system_tpu_torch import RAGConfig, create_engine
    from modular_rag_system_tpu_torch.models import modernbert as MB
    from modular_rag_system_tpu_torch.types import Document

    cuda = device != "cpu"
    L = config["max_position_embeddings"]
    window = config["local_attention"] // 2
    t0 = time.perf_counter()
    ckpt = modernbert_checkpoint(work / "modernbert", config)
    eng = create_engine(RAGConfig.load(overrides={
        "embedding.hf_checkpoint": str(ckpt), "embedding.dim": config["hidden_size"],
        "embedding.lexical_dim": 0, "embedding.max_seq_len": L,
        "embedding.attention_impl": "flash", "embedding.dtype": "bfloat16",
        "index.tier": "auto", "store.storage_path": str(work / "modernbert_store")}),
        device=device)
    enc = getattr(eng.encoder, "dense", eng.encoder)
    blocks = enc.module.blocks
    n_global = sum(b.is_global for b in blocks)
    n_local = len(blocks) - n_global
    log(f"longdoc engine: {type(enc.module).__name__}, {len(blocks)} layers ({n_global} "
        f"global, {n_local} with window {window}), max_seq_len {enc.max_seq_len}, built with "
        f"its checkpoint in {time.perf_counter() - t0:.1f} s")
    if not (isinstance(enc.module, MB.ModernBertModule) and enc.max_seq_len == L
            and {b.attn.window for b in blocks if not b.is_global} == {window}):
        raise AssertionError("the longdoc engine is not the checkpoint's ModernBERT encoder")
    pool = list(passages) + list(know)
    r = np.random.default_rng(7)
    docs = ["\n\n".join(pool[i] for i in r.choice(len(pool), c, replace=False)) for c in pieces]
    ids, mask = enc._crop_seq(*enc.tokenizer.encode_batch(docs))
    lengths = mask.sum(1).tolist()
    if ids.shape[1] != L or min(lengths) == L:
        raise AssertionError(f"the documents reach {ids.shape[1]} positions, lengths {lengths}")

    forwards = [0]
    forward_tokens = enc.forward_tokens

    def counted(ids, mask):
        forwards[0] += 1
        return forward_tokens(ids, mask)

    enc.forward_tokens = counted
    kernels.reset_launches()
    t0 = time.perf_counter()
    eng.add_documents([Document(content=t, source="long") for t in docs])
    if cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(kernels.launches)
    enc.forward_tokens = forward_tokens
    log(f"longdoc engine ingest: {len(docs)} documents of {lengths} tokens in {dt:.2f} s "
        f"(first call), {forwards[0]} forwards; launches {counts}")
    want = {"mea_attention": n_global * forwards[0], "mea_attention_window": n_local * forwards[0]}
    if not forwards[0] or {k: n for k, n in counts.items() if n} != want:
        raise AssertionError(f"longdoc ingest launched {counts}, expected {want}")
    hit = eng.query(docs[3], max_results=1, similarity_threshold=0.0).documents
    if eng.index.count != len(docs) or not hit or hit[0].content != docs[3]:
        raise AssertionError("a long document is not its own nearest row")

    # both modes at the first global and the first local layer's inputs
    captured = {}
    mea = MB.mea_attention

    def capture(q, k, v, pad, w=None):
        captured.setdefault(w, (q.clone(), k.clone(), v.clone(), pad.clone()))
        return mea(q, k, v, pad, w)

    MB.mea_attention = capture
    try:
        enc.encode_device(docs)
    finally:
        MB.mea_attention = mea
    out = {}
    for name, w in (("mea_attention", None), ("mea_attention_window", window)):
        q, k, v, pad = captured[w]
        layer = "global" if w is None else "local"
        if cuda:
            out[name] = (*time_mea(q, k, v, pad, spec, f"at ModernBERT's first {layer} "
                                   f"layer (the long-document batch)", w), want[name])
            if w is None:
                out[name][0].update(time_mea_template(q, k, v, pad))
        else:  # the CPU runs the plain version itself
            out[name] = ({}, 0.0, want[name])
    if cuda:
        out["mea_attention"][0]["crossover"] = mea_crossover(q.device)
    eng.shutdown()
    del eng, enc, captured, q, k, v, pad
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    return out



# ---------------------------------------------------------------------------
# phase 8: two processes on the card, one gloo group (parallel/multihost.py)
MH_RANKS = 2
MH_SHARDS = 2  # index shards a process: a 2 x 2 layout whose slices are the processes
MH_Q1 = 16  # the Q=1 queries held against phase 3's answers
MH_TRAIN_STEPS = 5
MH_FEEDBACK_STEPS = 5
# the ranks' answers against phase 3's one device: equal ids, except where
# two documents tie within the f32 master rescore's rounding (the same
# rows rescored in another shape)
MH_TIE_TOL = 1e-6


def mh_answers(eng, questions):
    """(ids, similarities) of every question at Q=256 (``query_batch``
    calls of at most 256) and of the first ``MH_Q1`` at Q=1; no recency
    weight, so the similarities are the search's scores (the documents'
    ages differ between engines)."""
    kw = dict(similarity_threshold=0.0, time_weight=0.0)
    q256 = [r for lo in range(0, len(questions), 256)
            for r in eng.query_batch(questions[lo:lo + 256], **kw)]
    q1 = [eng.query(t, **kw) for t in questions[:MH_Q1]]
    return {"q256": _lists(q256), "q1": _lists(q1)}


def _wall(fn, cuda, reps=10):
    """Median wall ms of ``fn`` (after a warm-up call), synchronized."""
    import torch

    def sync():
        if cuda:
            torch.cuda.synchronize()

    fn()
    times = []
    for _ in range(reps):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def mh_exact(idx, q, k):
    """The exact top-k across the ranks without the package's merge or
    collectives: each local shard's ``exact_topk_raw``, gathered with
    ``all_gather_object`` and merged here by two stable sorts (global id,
    then score descending) -> (vals, gids int64) on q's device."""
    import torch
    import torch.distributed as dist

    from modular_rag_system_tpu_torch.ops.exact import exact_topk_raw

    S, vals, gids = idx.S, [], []
    for c, E_s in enumerate(idx.E):
        s = idx._s0 + c
        v, r = exact_topk_raw(E_s, max(0, (idx.count - s + S - 1) // S), q.to(E_s.device),
                              min(k, idx.cap_s))
        vals.append(v.cpu())
        gids.append(torch.where(torch.isfinite(v), r.long() * S + s, 2**62).cpu())
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (vals, gids))
    v = torch.cat([x for vs, _ in every for x in vs], 1).to(q.device)
    g = torch.cat([x for _, gs in every for x in gs], 1).to(q.device)
    o = torch.argsort(g, dim=1, stable=True)
    v, g = v.gather(1, o), g.gather(1, o)
    o = torch.argsort(v, dim=1, descending=True, stable=True)[:, :k]
    return v.gather(1, o), g.gather(1, o)


def mh_check_exact(idx, q, k, what):
    """The route's top-k (the index's own protocol, collectives included)
    against ``mh_exact``: recall@k, and the scores, both lists sorted,
    within 1e-5.  Returns the recall."""
    with idx._lock:
        vals, gids = idx.search_core(k)(idx.search_ops(k), idx.count, q)
    ev, eg = mh_exact(idx, q, k)
    recall = sum(len(set(a) & set(b)) for a, b in
                 zip(gids.tolist(), eg.tolist())) / eg.numel()
    err = (vals - ev).abs().max().item()
    log(f"{what} vs the exact reference merged here: recall@{k} {recall:.4f}, scores "
        f"within {err:.2e}")
    if err > 1e-5:
        raise AssertionError(f"{what}: scores differ from the exact reference by {err}")
    return recall


def mh_search_stages(eng, questions, cuda):
    """Per Q in (1, 256): the embed stage, the search stage (each local
    shard's search, the merge within the rank, the all-gather and the
    merge across ranks) and the all-gather alone at the search's
    candidate shape, median wall ms."""
    from modular_rag_system_tpu_torch.parallel.multihost import all_gather_candidates

    idx, out = eng.index, {}
    k = eng._initial_k(eng.config.retrieval.max_results, False)
    for Q in (1, 256):
        texts = questions[:Q]
        q = eng.embed_queries(texts)

        def search():
            return idx.search_core(k)(idx.search_ops(k), idx.count, q)

        v, g = search()
        out[Q] = {"embed": _wall(lambda: eng.embed_queries(texts), cuda),
                  "search": _wall(search, cuda),
                  "gather": _wall(lambda: all_gather_candidates(v, g), cuda),
                  "gather_bytes": v.numel() * 8}
    return out


def mh_engine(work, kernels, know, questions, passages, ref, device, rank, out):
    """Phase 8 (b), (c) in one rank: a ``mesh.multihost`` engine, the text
    rows (single-pass per local shard), then the fill to 1,048,576 rows
    (two-pass per local shard)."""
    import torch

    from modular_rag_system_tpu_torch import RAGConfig, create_engine
    from modular_rag_system_tpu_torch.types import Document

    cuda = device != "cpu"
    cfg = RAGConfig.load(overrides={"index.tier": "auto", "mesh.multihost": True,
                                    "store.storage_path": str(work / f"mh_engine{rank}"),
                                    "store.snapshot_on_shutdown": False})
    eng = create_engine(cfg, device=device, index_devices=[device] * MH_SHARDS)
    idx = eng.index
    layout = (cfg.mesh.index_shards, cfg.mesh.dcn_slices, idx.S, idx._s0, len(idx.devices))
    log(f"engine: {eng.encoder.name}, dim {idx.dim}, (index_shards, dcn_slices, S, first "
        f"global shard, local shards) {layout}, cap_s {idx.cap_s}")
    if layout != (MH_RANKS * MH_SHARDS, MH_RANKS, MH_RANKS * MH_SHARDS, rank * MH_SHARDS,
                  MH_SHARDS) or idx.group is None:
        raise AssertionError(f"unexpected multihost layout {layout}")
    t0 = time.perf_counter()
    eng.add_documents([Document(content=t, source="knowledge") for t in know])
    for p in passages:
        eng.add_text(p, source="qa")
    dt = time.perf_counter() - t0
    log(f"ingest text (SPMD, every rank the same calls): {idx.count} rows in {dt:.2f} s "
        f"({idx.count / dt:.1f} rows/s)")
    if idx.count != ref["n_text"]:
        raise AssertionError(f"{idx.count} text rows, phase 3 had {ref['n_text']}")
    got = {}
    searches = len(range(0, len(questions), 256)) + MH_Q1
    n = drive(kernels, "multihost single-pass (2 local shards)", "fused_topk_int8",
              lambda: got.update(mh_answers(eng, questions)))
    if n != MH_SHARDS * searches:
        raise AssertionError(f"{n} fused_topk_int8 launches, expected {MH_SHARDS} local "
                             f"shards x {searches} searches")
    out["text"], out["launches"] = got, {"text": n}
    out["stages_text"] = mh_search_stages(eng, questions, cuda)

    g = torch.Generator(device=idx.device).manual_seed(1)  # phase 3's fill rows
    fill(eng, g, FULL_ROWS)
    if idx.capacity != FULL_ROWS or idx.effective_tier() != "int8":
        raise AssertionError(f"capacity {idx.capacity}, tier {idx.effective_tier()}")
    n = drive(kernels, "multihost two-pass (2 local shards)", "binmax_int8",
              lambda: (eng.query_batch(questions[:256], similarity_threshold=0.0),
                       eng.query(questions[0], similarity_threshold=0.0)))
    if n != MH_SHARDS * 2:
        raise AssertionError(f"{n} binmax_int8 launches, expected {MH_SHARDS} x 2")
    out["launches"]["two_pass"] = n
    rec = mh_check_exact(idx, eng.embed_queries(questions[:256]), 10,
                         f"multihost two-pass route ({idx.count} rows)")
    if rec != 1.0:
        raise AssertionError(f"multihost two-pass recall@10 {rec} != 1.0")
    out["stages_two_pass"] = mh_search_stages(eng, questions, cuda)
    out["index_bytes"] = idx.memory_bytes()
    eng.shutdown()


def mh_train(work, questions, passages, ref, device, rank, out):
    """Phase 8 (d) in one rank: the trainer on (2, 1) and (1, 2) over the
    bundled dense half at full width, phase 6's batches."""
    import random

    import torch

    from modular_rag_system_tpu_torch import RAGConfig
    from modular_rag_system_tpu_torch.models.default_ckpt import build_default_encoder
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer
    from modular_rag_system_tpu_torch.parallel import multihost
    from modular_rag_system_tpu_torch.parallel.mesh import make_train_mesh

    cuda = device != "cpu"
    order = list(range(len(questions)))  # phase 6's batches
    random.Random(0).shuffle(order)

    def batch(s, size=TRAIN_BATCH):
        rows = [order[(s * TRAIN_BATCH + i) % len(order)] for i in range(size)]
        return [questions[i] for i in rows], [passages[i] for i in rows]

    out["train"] = {}
    for D, M in ((2, 1), (1, 2)):
        name = f"{D}x{M}"
        mesh = make_train_mesh(D, M)
        trainer = ContrastiveTrainer(build_default_encoder(RAGConfig(), device), mesh,
                                     learning_rate=TRAIN_LR)
        losses, step_ms = [], []
        for s in range(MH_TRAIN_STEPS):
            t0 = time.perf_counter()
            loss, acc = trainer.step(*batch(s))
            if cuda:
                torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(loss)
        # the loss falls: step 0's batch again, at the trained weights
        after, _ = trainer.evaluate(*batch(0))
        res = {"losses": losses, "step_ms": step_ms, "batch0_after": after}
        log(f"train {name}: losses {[round(x, 5) for x in losses]}, step 0's batch after "
            f"{MH_TRAIN_STEPS} steps {after:.5f}; step ms {[round(x, 1) for x in step_ms]}")
        if abs(losses[0] - ref["step0"]) > STEP0_LOSS_TOL:
            raise AssertionError(f"train {name}: step 0 loss {losses[0]} against phase 6's "
                                 f"{ref['step0']}")
        if not all(map(math.isfinite, losses)) or not after < losses[0]:
            raise AssertionError(f"train {name}: the loss did not fall: {losses}, {after}")
        if D == 2:
            # 255 pairs: one clone row pads the batch to 256; its loss
            # before the step against one device's over the 255 pairs
            q255, p255 = batch(MH_TRAIN_STEPS, TRAIN_BATCH - 1)
            l_mesh, _ = trainer.evaluate(q255, p255)
            trainer.sync_encoder()
            l_one, _ = ContrastiveTrainer(trainer.encoder).evaluate(q255, p255)
            loss, _ = trainer.step(q255, p255)
            log(f"train {name}: 255-pair batch (a clone row) loss {l_mesh:.5f}, one device "
                f"over the 255 pairs {l_one:.5f}; its step {loss:.5f}")
            if abs(l_mesh - l_one) > STEP0_LOSS_TOL or not math.isfinite(loss):
                raise AssertionError(f"train {name}: the clone-row batch {l_mesh} {l_one}")
            flat = torch.cat([p.detach().reshape(-1) for p in trainer.params.values()])
            res["allreduce_ms"] = _wall(lambda: multihost.all_reduce_sum(flat, mesh.data_group),
                                        cuda, reps=5)
            res["allreduce_mb"] = flat.numel() * 4 / 1e6
            log(f"train {name}: gradient all-reduce ({res['allreduce_mb']:.1f} MB of f32 over "
                f"the data group, staged through the host) {res['allreduce_ms']:.2f} ms")
        else:
            ckpt = work / "mh_ckpt.pt"
            trainer.save_checkpoint(str(ckpt))
            full = trainer.full(trainer.params)
            one = ContrastiveTrainer(build_default_encoder(RAGConfig(), device),
                                     learning_rate=TRAIN_LR)
            one.restore_checkpoint(str(ckpt))
            same = all(torch.equal(one.params[k].detach(), v) for k, v in full.items())
            log(f"train {name}: checkpoint ({ckpt.stat().st_size / 1e6:.1f} MB, written by "
                f"rank 0) restored into a one-device trainer: tensors equal {same}, step "
                f"{one.step_count}")
            if not same or one.step_count != trainer.step_count:
                raise AssertionError(f"train {name}: the checkpoint restored other tensors")
        out["train"][name] = res
        del trainer
        if cuda:
            torch.cuda.empty_cache()


def mh_fine_tune(work, kernels, know, questions, passages, device, rank, out):
    """Phase 8 (e) in one rank: ``fine_tune_from_feedback`` under the live
    group of 2 (a (1, 2) layout), then the questions through
    ``fused_topk_int8`` on the re-embedded index, held against the exact
    tier."""
    import random

    from modular_rag_system_tpu_torch import RAGConfig
    from modular_rag_system_tpu_torch.facade import EnhancedRAGSystem
    from modular_rag_system_tpu_torch.types import Document

    cfg = RAGConfig.load(overrides={"index.tier": "int8", "serving.file_server_port": 0,
                                    "store.storage_path": str(work / f"mh_fine_tune{rank}")})
    system = EnhancedRAGSystem(cfg, device=device, enable_llm=False)
    try:
        eng = system.engine
        eng.add_documents([Document(content=t, source="knowledge") for t in know])
        for p in passages:
            eng.add_text(p, source="qa")
        order = list(range(len(questions)))
        random.Random(0).shuffle(order)
        for i in order[:FEEDBACK_PAIRS]:
            system.record_feedback(questions[i], "positive", matched_content=passages[i])
        t0 = time.perf_counter()
        metrics = system.fine_tune_from_feedback(steps=MH_FEEDBACK_STEPS)
        dt = time.perf_counter() - t0
        shape = system._trainer.mesh.shape
        log(f"fine_tune_from_feedback({MH_FEEDBACK_STEPS} steps, {FEEDBACK_PAIRS} pairs) on "
            f"a {shape} layout in {dt:.2f} s: {metrics}")
        if shape != {"data": 1, "model": 2} or metrics is None or not math.isfinite(
                metrics["final_loss"]):
            raise AssertionError(f"fine_tune_from_feedback: {shape} {metrics}")
        got = {}
        n = route_only(kernels, f"query_batch x{len(questions)} after the fine-tune",
                       "fused_topk_int8", lambda: got.update(mh_answers(eng, questions)))
        q = eng.embed_queries(questions)
        for lo in range(0, len(questions), 256):
            rec = check_against_exact(eng, q[lo:lo + 256], 10, 1e-5,
                                      "the re-embedded index")
            if rec != 1.0:
                raise AssertionError(f"recall@10 {rec} against the exact tier after the "
                                     f"fine-tune")
        out["fine_tune"], out["launches"]["fine_tune"] = got, n
        out["fine_tune_s"] = dt
    finally:
        system.shutdown()


def multihost_rank(argv) -> int:
    """One rank of phase 8 (``chip_smoke.py --multihost-rank WORK DEVICE
    RANK N HOST:PORT``): (b)-(e), its report to ``WORK/mh_rank<RANK>.json``."""
    work, device, rank, n, coord = Path(argv[0]), argv[1], int(argv[2]), int(argv[3]), argv[4]
    sys.path.insert(0, str(ROOT))
    import torch

    from modular_rag_system_tpu_torch import kernels
    from modular_rag_system_tpu_torch.parallel import multihost

    if device != "cpu" and not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    multihost.initialize_multihost(coord, n, rank)
    ref = json.loads((work / "mh_ref.json").read_text())
    know, questions, passages = load_corpus()
    out = {}
    t0 = time.perf_counter()
    mh_engine(work, kernels, know, questions, passages, ref, device, rank, out)
    t1 = time.perf_counter()
    mh_train(work, questions, passages, ref, device, rank, out)
    t2 = time.perf_counter()
    mh_fine_tune(work, kernels, know, questions, passages, device, rank, out)
    out["seconds"] = {"engine": t1 - t0, "train": t2 - t1, "fine_tune": time.perf_counter() - t2}
    if device != "cpu":
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    (work / f"mh_rank{rank}.json").write_text(json.dumps(out))
    torch.distributed.destroy_process_group()
    return 0


def multihost_phase(work, ref, device="cuda"):
    """Phase 8: two processes on ``device``, one gloo group of 2.  (a)
    ``mh_check`` with tensors on the device; (b)-(e) in two ranks of this
    script (``multihost_rank``), each failure of a rank failing the
    phase: a ``mesh.multihost`` engine over the text rows and at
    1,048,576 rows, the trainer on (2, 1) and (1, 2), and
    ``fine_tune_from_feedback``.  The ranks' answers must equal each
    other's and phase 3's (``ref``).  Returns each rank's launches of
    ``fused_topk_int8`` and ``binmax_int8``."""
    from modular_rag_system_tpu_torch.parallel.mh_check import (
        spawn_ranks,
        spawn_two_process_cluster,
    )

    t0 = time.perf_counter()
    res = spawn_two_process_cluster(device=device, shards_per_process=MH_SHARDS, timeout=300,
                                    repo_dir=str(ROOT))
    for r, (_, out, _) in enumerate(res):
        for line in out.strip().splitlines():
            log(f"  mh_check rank {r}: {line}")
    log(f"multihost (a): mh_check, 2 processes x {MH_SHARDS} shards on {device}: every "
        f"marker in both ranks, {time.perf_counter() - t0:.1f} s")
    (work / "mh_ref.json").write_text(json.dumps(ref))
    t0 = time.perf_counter()
    res = spawn_ranks([str(ROOT / "chip_smoke.py"), "--multihost-rank", str(work), device],
                      MH_RANKS, timeout=720, cwd=str(ROOT))
    for r, (_, out, _) in enumerate(res):
        for line in out.strip().splitlines():
            log(f"  rank {r}: {line}")
    reps = [json.loads((work / f"mh_rank{r}.json").read_text()) for r in range(MH_RANKS)]
    log(f"multihost (b)-(e): both ranks exited 0 after {time.perf_counter() - t0:.1f} s "
        f"(rank 0's seconds {reps[0]['seconds']}, peak device memory a rank "
        f"{[round(r.get('peak_gb', 0.0), 2) for r in reps]} GB)")
    for key in ("text", "fine_tune"):
        if reps[0][key] != reps[1][key]:
            raise AssertionError(f"multihost: the ranks' {key} answers differ")
    for key in ("q256", "q1"):
        hold_near_ties(reps[0]["text"][key], ref["text"][key], MH_TIE_TOL,
                       f"multihost {key} answers (both ranks) against phase 3's one device")
    for name, key in (("single-pass (text rows)", "stages_text"),
                      (f"two-pass ({FULL_ROWS:,} rows)", "stages_two_pass")):
        for Q in ("1", "256"):
            st = [r[key][Q] for r in reps]
            log(f"multihost {name} Q={Q}: search stage {[round(x['search'], 3) for x in st]} ms "
                f"(ranks 0, 1; the all-gather of {st[0]['gather_bytes']} bytes a rank "
                f"{[round(x['gather'], 3) for x in st]} ms, share "
                f"{[round(x['gather'] / x['search'], 3) for x in st]}); embed "
                f"{[round(x['embed'], 2) for x in st]} ms")
    for Q in (1, 256):
        log(f"  beside phase 4e (4 shards, one process, single-pass) Q={Q}: search "
            f"{ref['stages_4e'][Q]['search']:.3f} ms, embed "
            f"{ref['stages_4e'][Q]['embed (tokenize+lexical+forward)']:.2f} ms")
    for name in ("2x1", "1x2"):
        st = [r["train"][name] for r in reps]
        log(f"multihost train {name}: step ms median over steps 1-{MH_TRAIN_STEPS - 1} "
            f"{[round(statistics.median(x['step_ms'][1:]), 2) for x in st]} (ranks 0, 1; "
            f"phase 6's one device {ref['step_ms']} ms), step 0 loss {st[0]['losses'][0]:.5f} "
            f"(phase 6 {ref['step0']:.5f})"
            + (f"; gradient all-reduce {[round(x['allreduce_ms'], 2) for x in st]} ms for "
               f"{st[0]['allreduce_mb']:.1f} MB" if "allreduce_ms" in st[0] else ""))
    launches = {"fused_topk_int8": {f"rank{r}": {"text": x["launches"]["text"],
                                                 "fine_tune": x["launches"]["fine_tune"]}
                                    for r, x in enumerate(reps)},
                "binmax_int8": {f"rank{r}": {"two_pass": x["launches"]["two_pass"]}
                                for r, x in enumerate(reps)}}
    log(f"multihost launches (per rank, {MH_SHARDS} local shards a search): {launches}")
    return launches


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
            "rescan": check_rescan(g, dev)}
    # the fine kernels' int4 mode is reported beside their bf16/int8 figures
    errs4 = {}
    for kname, check in (("fine_scores", check_fine_scores), ("fine_topk", check_fine_topk),
                         ("fine_binmax", check_fine_binmax)):
        w = check(g, dev)
        errs[kname], errs4[kname] = max(w["bf16"], w["int8"]), w["int4"]
    mea_errs = check_mea(g, dev)
    errs["mea_attention"] = mea_errs[torch.bfloat16]  # the engine's model dtype
    torch.cuda.empty_cache()
    entries, launches, entries4, launches4 = {}, {}, {}, {}
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
    text_ref = mh_answers(eng, questions)  # phase 8's ranks answer the same
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
    entries["rescan"], launches["rescan"], err = time_rescan(
        eng, eng.embed_queries(questions[:256]), spec, kernels)
    errs["rescan"] = max(errs["rescan"], err)
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

    # a third small engine whose encoder runs the mea_attention kernel
    entries["mea_attention"], launches["mea_attention"], err = flash_engine(
        work, kernels, small, know, questions, passages, r_small, spec, dev)
    errs["mea_attention"] = max(errs["mea_attention"], err)
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
    entries["fine_topk"], err = time_fine(idx, q256[:16], 512, 20, spec, "fine_topk")
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
    rec_int8 = rec
    entries["fine_scores"], err = time_fine(idx, q256, 8, 20, spec, "fine_scores")
    errs["fine_scores"] = max(errs["fine_scores"], err)
    # the maxima probe: on no serving path, driven through its wrapper at
    # the lists the route above probed; the fine stage's streaming floor
    blk, vcnt = probe_lists(idx, q256, 8, sort=True)
    launches["fine_binmax"] = drive(
        kernels, "fine_binmax (maxima probe, int8)", "fine_binmax",
        lambda: V.fine_binmax_call(iv.E_c3, iv.scales3, q256, blk, vcnt))
    entries["fine_binmax"], err = time_fine(idx, q256, 8, 20, spec, "fine_binmax")
    errs["fine_binmax"] = max(errs["fine_binmax"], err)
    int8_fine_bytes = iv.fine_bytes()
    tp = phase("4b (int8 rebuild, fine_scores and fine_binmax timing)", tp)
    log(f"peak device memory so far {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")

    # the deep filtered refill: exact top-k per row block at Q=256 (the
    # peak counter restarts here)
    refill_s = exact_refill(eng2, questions)
    tp = phase("4b' (the exact path at Q=256)", tp)

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
    # the snapshot on disk is this engine's own: not written again
    eng3.config.store.snapshot_on_shutdown = False
    eng3.shutdown()
    del eng3, iv
    gc.collect()
    torch.cuda.empty_cache()
    tp = phase("4c (snapshot, warm restart)", tp)

    # ---- phase 4d: the same snapshot served with an int4 fine copy
    int4_route(storage, kernels, V, questions, passages, spec, rec_int8, r_full,
               int8_fine_bytes, entries4, launches4, errs4)
    gc.collect()
    torch.cuda.empty_cache()
    tp = phase("4d (int4 restart, int4 fine kernels)", tp)

    # ---- phase 4e: the sharded index (4 shards on the card)
    shard_launches, stages_4e = sharded_phase(work, storage, kernels, know, questions,
                                              passages, r_ivf, refill_s)
    tp = phase("4e (sharded index)", tp)

    # ---- phase 5: the facade, the HTTP server, the lifecycle, the launcher
    entry_launches = entry_points(work, kernels, know, questions, passages)
    tp = phase("5 (entry points)", tp)

    # ---- phase 6: the trainer, fine_tune_from_feedback, build_default_encoder
    trained = train_phase(work, kernels, know, questions, passages, spec)
    entry_launches["fine_tune"] = trained["fine_tune_launches"]
    tp = phase("6 (train)", tp)

    # ---- phase 7: an HF checkpoint at all-MiniLM-L6-v2's widths, the native
    # tokenizer, the external eval
    hf = hf_phase(work, kernels, know, questions, passages, spec, trained.get("step_ms"))
    errs["mea_attention"] = max(errs["mea_attention"], hf["mea_L256_err"])
    tp = phase("7 (HF encoder, native tokenizer, external eval)", tp)

    # ---- phase 7b: ModernBERT on long documents, both modes of mea_attention
    longdoc = longdoc_phase(work, kernels, know, passages, spec)
    errs["mea_attention"] = max(errs["mea_attention"], longdoc["mea_attention"][1])
    tp = phase("7b (ModernBERT, long documents)", tp)

    # ---- phase 8: two processes on the card, one gloo group
    gc.collect()
    torch.cuda.empty_cache()
    mh_launches = multihost_phase(work, {
        "text": text_ref, "n_text": n_text, "step0": trained["losses"][0],
        "step_ms": trained.get("step_ms"), "stages_4e": stages_4e})
    tp = phase("8 (two processes: mh_check, engine, trainer layouts, fine-tune)", tp)

    out = []
    replaces = {"binmax_int8": "modular_rag_system_tpu/ops/binmax_topk.py:450",
                "fused_topk_int8": "modular_rag_system_tpu/ops/fused_topk.py:282",
                "binmax": "modular_rag_system_tpu/ops/binmax_topk.py:225",
                "fused_topk": "modular_rag_system_tpu/ops/fused_topk.py:147",
                "fine_scores": "modular_rag_system_tpu/ops/ivf2.py:763",
                "fine_topk": "modular_rag_system_tpu/ops/ivf2.py:529",
                "fine_binmax": "modular_rag_system_tpu/ops/ivf2.py:664",
                "rescan": "modular_rag_system_tpu/ops/binmax_topk.py:275",
                "mea_attention": "modular_rag_system_tpu/ops/flash_attention.py:53"}
    for kname, tpu_src in replaces.items():
        entry = {"name": kname, "route": "cuda",
                 "source": f"modular_rag_system_tpu_torch/kernels/{kernels.KERNELS[kname]}.cu",
                 "replaces": tpu_src, "launches": launches[kname],
                 "max_abs_err": errs[kname], **entries[kname]}
        if kname == "fused_topk_int8":  # its launches through the entry points
            entry["entry_points_launches"] = entry_launches
        if kname in shard_launches:  # per shard on the sharded routes (phase 4e)
            entry["sharded_launches"] = shard_launches[kname]
        if kname in mh_launches:  # each rank's, per local shard (phase 8)
            entry["multihost_launches"] = mh_launches[kname]
        if kname in ("fused_topk_int8", "mea_attention"):  # the HF engines (phase 7)
            entry["hf_launches"] = hf[kname]
        if kname == "mea_attention":  # alone at the HF checkpoint's L = 256 bucket,
            entry["L256"] = hf["mea_L256"]  # and in ModernBERT's global layers (7b)
            entry["longdoc"] = {"launches": longdoc[kname][2], "max_abs_err": longdoc[kname][1],
                                **longdoc[kname][0]}
        if kname in entries4:  # the same source's int4 mode, on the int4 route
            entry["int4"] = {"launches": launches4[kname], "max_abs_err": errs4[kname],
                             **entries4[kname]}
        out.append(entry)
    # beyond the TPU kernels: the window mode of mea_attention (phase 7b's
    # ModernBERT local layers), the trainer's update (phase 6's steps, and
    # the check at the trainer's size)
    timing, err, n = longdoc["mea_attention_window"]
    out.append({"name": "mea_attention_window", "route": "cuda",
                "source": f"modular_rag_system_tpu_torch/kernels/"
                          f"{kernels.KERNELS['mea_attention_window']}.cu",
                "replaces": None, "launches": n, "max_abs_err": err, **timing})
    for kname, n in trained["update_launches"].items():
        out.append({"name": kname, "route": "cuda",
                    "source": f"modular_rag_system_tpu_torch/kernels/{kernels.KERNELS[kname]}.cu",
                    "replaces": None, "launches": n, **trained["update_kernels"][kname]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": out}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--multihost-rank"]:  # one rank of phase 8
        sys.exit(multihost_rank(sys.argv[2:]))
    sys.exit(main())
