"""The long-document ModernBERT cell (``modernbert-ingest-8k``) on the CPU
at a small size, through ``run.main`` with its own overrides: a sound
run and its last line, a traced run and the metrics the CPU can read,
the control (the reference in fp8) above ``row_gap``'s limit and the
program's own reading below it, a planted fault turning ``correct``
false; and the arithmetic the cell's per-layer metrics rest on."""

from __future__ import annotations

import json
from contextlib import redirect_stdout
from io import StringIO
from types import SimpleNamespace

import pytest
import torch

from portbench import common, kernel_share
from portbench.common import SPECS
from portbench.hooks import Recorder
from portbench.roofline import mea_attention as mea_roof
from portbench.roofline import modernbert as mb_roof

CELL = "modernbert-ingest-8k"
# a whole period of the layer pattern and the next global layer, at
# small widths; the smallest vocab the bundled WordPiece pieces fill
TINY_HF = {"vocab_size": 16384, "hidden_size": 64, "num_hidden_layers": 4,
           "num_attention_heads": 4, "intermediate_size": 96, "local_attention": 16}
TINY = {"config": {"hf_config": TINY_HF, "served_len": 512, "corpus_rows": 16384,
                   "engine": {"embedding.dim": 64, "embedding.max_seq_len": 512}},
        "cell": {"route": None},
        "params": {"batch": 4, "warm_calls": 1, "max_rows_per_s": 200, "judge_max": 16,
                   "pieces_min": 2, "pieces_max": 40}}


def _run(capsys, trace=0, seed=11):
    from portbench import run

    rc = run.main(["--workload", CELL, "--seed", str(seed), "--seconds", "1",
                   "--trace", str(trace)], device="cpu", overrides=TINY)
    lines = capsys.readouterr().out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None)


def test_sound_run(capsys):
    rc, out = _run(capsys)
    assert rc == 0 and out["correct"] is True, out and out["checks"]
    assert set(out["metrics"]) == {"ingest_rows_s", "setup_s"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    for name in ("row_gap", "token_gap"):
        assert out["checks"][name]["limit"] == common.cell(CELL)["limits"][name]
        assert out["checks"][name]["value"] <= out["checks"][name]["limit"]


def test_traced_run_reads_the_program(capsys):
    rc, out = _run(capsys, trace=1, seed=12)
    assert rc == 0 and out["correct"] is True
    bench = common.benchmark()
    names = {m["name"] for m in common.per_layer_for(bench, CELL)}
    # its own: the ModernBERT FLOPs and the two modes' rooflines; the rest
    # are the ingest cell's readers of the same write path
    assert names == {"longdoc.embed_mfu", "longdoc.attn_global_roofline",
                     "longdoc.attn_local_roofline", "ingest.tokenize_ms",
                     "ingest.store_upsert_ms", "ingest.index_add_ms", "device_idle_share.ingest",
                     "ingest.store_lookup_ms", "ingest.store_rows_ms", "ingest.store_write_ms",
                     "ingest.store_commit_ms", "ingest.real_token_share", "ingest.gc_ms"}
    # the CPU has no peak, no kernel and no device time: those read nothing
    assert set(out["metrics"]) == names - {"longdoc.embed_mfu", "longdoc.attn_global_roofline",
                                           "longdoc.attn_local_roofline",
                                           "device_idle_share.ingest"}
    assert 0 < out["metrics"]["ingest.real_token_share"]["value"] <= 100
    assert out["metrics"]["ingest.tokenize_ms"]["value"] > 0


@pytest.mark.parametrize("precision,above", [("fp8", True), ("program", False)])
def test_calibration_readings_against_the_limit(precision, above):
    from portbench import calibrate

    over = json.dumps({k: v for k, v in TINY.items() if k != "cell"})
    buf = StringIO()
    with redirect_stdout(buf):
        assert calibrate.main(["--workload", CELL, "--seeds", "21", "--precision", precision,
                               "--device", "cpu", "--seconds", "2", "--overrides", over]) == 0
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    for name in ("row_gap", "token_gap"):
        limit = common.cell(CELL)["limits"][name]
        assert (got[name] > limit) is above, (name, got, limit)


def test_altered_rows_turn_correct_false(capsys, monkeypatch):
    from modular_rag_system_tpu_torch.index import DeviceIndex

    orig = DeviceIndex.add

    def add(self, mat):
        x = torch.as_tensor(mat).clone()
        x[:, 0] = -x[:, 0] + 0.1
        return orig(self, x)

    monkeypatch.setattr(DeviceIndex, "add", add)
    rc, out = _run(capsys)
    assert rc == 0 and out["correct"] is False


def test_token_gap_sees_what_pooling_averages_away(capsys, monkeypatch):
    """A fault whose sign alternates from token to token leaves the pooled
    rows nearly as they were; the final hidden states show it."""
    from modular_rag_system_tpu_torch.models import modernbert

    orig = modernbert.BiasFreeLayerNorm.forward

    def forward(self, x):
        y = orig(self, x)
        if self.dtype == torch.float32:  # final_norm: the only f32 norm output
            sign = 1.0 - 2.0 * (torch.arange(y.shape[1]) % 2).float()
            y = y + 0.05 * sign[None, :, None]
        return y

    monkeypatch.setattr(modernbert.BiasFreeLayerNorm, "forward", forward)
    rc, out = _run(capsys, seed=13)
    limits = common.cell(CELL)["limits"]
    assert rc == 0 and out["correct"] is False
    assert out["checks"]["token_gap"]["value"] > limits["token_gap"]
    assert out["checks"]["row_gap"]["value"] <= limits["row_gap"]


# ---------------------------------------------------------------------------
def test_forward_flops_at_the_published_widths():
    cfg = common.config("modernbert-embed-base")["hf_config"]
    assert mb_roof.layer_kinds(cfg) == (8, 14)
    assert 2 * mb_roof.linear_weights(cfg) == 220_594_176  # 220.6 MFLOP a token
    L, h = 8192, cfg["hidden_size"]
    glob = 4 * L * h  # 25.2 MFLOP a token and global layer
    local = 4 * h * mb_roof.band_pairs(L, 64) / L  # 0.39 MFLOP a token and local layer
    assert glob == 25_165_824 and round(local / 1e6, 2) == 0.39
    assert mb_roof.forward_flops(cfg, [L]) == L * (220_594_176 + 8 * glob) + 14 * 4 * h * \
        mb_roof.band_pairs(L, 64)
    # global attention near half of the forward's work at 8,192 positions
    assert 0.45 < 8 * glob * L / mb_roof.forward_flops(cfg, [L]) < 0.5


def test_mea_attention_bound_at_the_cell_shape():
    B, L, H, dh = 16, 8192, 12, 64
    spec = SPECS["H100"]
    full = mea_roof.bound_s(B * H * L * L, B * H * L, dh, spec)
    assert full * 1e3 == pytest.approx(3.3352, abs=5e-5)  # operations bound it
    local = mea_roof.bound_s(B * H * mb_roof.band_pairs(L, 64), B * H * L, dh, spec)
    assert local == mea_roof.nbytes(B * H * L, dh) / spec["bytes"]  # bytes bound it


def test_mea_kernel_names_by_mode():
    name = ("void (anonymous namespace)::mea_bf16_kernel<64, 64, 4, {}>(unsigned short "
            "const*, unsigned short const*, float, int)")
    assert kernel_share.mea_mode(name.format("true")) == "window"
    assert kernel_share.mea_mode(name.format("false")) == "full"
    assert kernel_share.mea_mode("void (anonymous namespace)::mea_f32_kernel<64, true>(float "
                                 "const*)") == "window"
    assert kernel_share.mea_mode("nvjet_tst_192x192_64x4_2x1_v_bz_coopB_TNN") is None
    trace = {"kernels": {name.format("true"): (0.25, 28), name.format("false"): (3.2, 16),
                         "other": (1.0, 5)}}
    assert kernel_share.device_seconds(trace, lambda n: kernel_share.mea_mode(n) == "full") == 3.2
    assert kernel_share.device_seconds(trace, lambda n: "absent" in n) is None


def test_counters_stop_with_the_profile():
    from modular_rag_system_tpu_torch.utils.profiling import TRACER

    class _Run:
        def __init__(self):
            self.state, self.trace_s = {}, 0.0

        def tick(self):
            pass

    run, rec = _Run(), Recorder(torch.device("cpu"))
    try:
        kernel_share.install(run, rec)
        rec.active = True
        for unit in range(4):
            TRACER.count("encoder.attn_global_pairs", 10)
            if unit == 1:
                run.trace_s = 5.0  # this unit's tick closed the profile
            run.tick()
        rec.active = False
        assert kernel_share.counters(run) == {"encoder.attn_global_pairs": 20}
    finally:
        rec.restore()
        TRACER.disable()
        TRACER.reset()


def test_readers_read_nothing_without_a_trace():
    run = SimpleNamespace(state={}, spec=SPECS["H100"],
                          config=common.config("modernbert-embed-base"))
    for kind in ("global", "local"):
        assert common.layer(f"longdoc.attn_{kind}_roofline").read(run, None, None) is None
