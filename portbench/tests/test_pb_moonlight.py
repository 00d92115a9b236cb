"""The mixture-of-experts long-section cell (``moonlight-ingest-4k``) on
the CPU at a small size, through ``run.main`` with its own overrides: a
sound run and its last line, a traced run and the metrics the CPU can
read, the control (the reference in fp8) above a limit and the program's
own reading below them, planted faults turning ``correct`` false; and the
arithmetic the cell's per-layer metrics rest on."""

from __future__ import annotations

import json
from contextlib import redirect_stdout
from io import StringIO
from types import SimpleNamespace

import pytest
import torch

from portbench import common
from portbench.common import SPECS
from portbench.roofline import deepseek_v3 as ds_roof
from portbench.roofline import mea_causal

CELL = "moonlight-ingest-4k"
# the published structure at small widths: 1 dense and 2 expert layers, 8
# experts 2 a token and 1 shared, q and k 24 wide and v 16; the smallest
# vocab the bundled WordPiece pieces fill
TINY_HF = {"vocab_size": 16384, "hidden_size": 32, "num_hidden_layers": 3,
           "num_attention_heads": 2, "num_key_value_heads": 2, "intermediate_size": 48,
           "moe_intermediate_size": 16, "n_routed_experts": 8, "num_experts_per_tok": 2,
           "n_shared_experts": 1, "kv_lora_rank": 16, "qk_nope_head_dim": 16,
           "qk_rope_head_dim": 8, "v_head_dim": 16, "max_position_embeddings": 512}
TINY = {"config": {"hf_config": TINY_HF, "served_len": 512, "corpus_rows": 16384,
                   "engine": {"embedding.dim": 32, "embedding.max_seq_len": 512}},
        "cell": {"route": None},
        "params": {"batch": 4, "warm_calls": 1, "max_rows_per_s": 200, "judge_max": 12,
                   "tokens_min": 16, "tokens_max": 400}}


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
    limits = common.cell(CELL)["limits"]
    assert set(out["checks"]) == {"row_gap", "token_gap", "route_gap", "store_mismatch"}
    for name, c in out["checks"].items():
        assert c["limit"] == limits[name] and c["value"] <= c["limit"]
    assert out["checks"]["route_gap"]["value"] == 0


def test_traced_run_reads_the_program(capsys):
    rc, out = _run(capsys, trace=1, seed=12)
    assert rc == 0 and out["correct"] is True
    names = {m["name"] for m in common.per_layer_for(common.benchmark(), CELL)}
    assert {"moedoc.embed_mfu", "moedoc.experts_ms", "moedoc.route_ms",
            "moedoc.attn_causal_roofline"} <= names
    # the CPU has no peak, no kernel and no device time: those read nothing
    assert set(out["metrics"]) == names - {"moedoc.embed_mfu", "moedoc.attn_causal_roofline",
                                           "device_idle_share.ingest"}
    assert out["metrics"]["moedoc.experts_ms"]["value"] > 0
    assert out["metrics"]["moedoc.route_ms"]["value"] > 0


@pytest.mark.parametrize("precision,above", [("fp8", True), ("program", False)])
def test_calibration_readings_against_the_limits(precision, above):
    from portbench import calibrate

    over = json.dumps({k: v for k, v in TINY.items() if k != "cell"})
    buf = StringIO()
    with redirect_stdout(buf):
        assert calibrate.main(["--workload", CELL, "--seeds", "21", "--precision", precision,
                               "--device", "cpu", "--seconds", "2", "--overrides", over]) == 0
    got = json.loads(buf.getvalue().strip().splitlines()[-1])
    limits = common.cell(CELL)["limits"]
    over_limit = {k for k in limits if got[k] > limits[k]}
    assert bool(over_limit) is above, (got, limits)
    if not above:
        assert got["route_gap"] == 0


def _softmax_route(logits, bias, top_k, scaling):
    s = torch.softmax(logits, dim=1)
    idx = torch.sort(s + bias, dim=1, descending=True, stable=True).indices[:, :top_k]
    w = s.gather(1, idx)
    return idx, w / w.sum(dim=1, keepdim=True) * scaling




def test_a_routing_fault_turns_correct_false(capsys, monkeypatch):
    from modular_rag_system_tpu_torch.models import deepseek_v3

    monkeypatch.setattr(deepseek_v3, "route", _softmax_route)
    rc, out = _run(capsys, seed=13)
    assert rc == 0 and out["correct"] is False, out["checks"]
    assert out["checks"]["route_gap"]["value"] > out["checks"]["route_gap"]["limit"]


def _drop_top_route(logits, bias, top_k, scaling):
    s = torch.sigmoid(logits)
    idx = torch.sort(s + bias, dim=1, descending=True, stable=True).indices[:, 1:top_k + 1]
    w = s.gather(1, idx)
    return idx, w / w.sum(dim=1, keepdim=True) * scaling


def test_a_left_out_top_expert_turns_correct_false(capsys, monkeypatch):
    """The router off by one rank (ranks 2..k + 1): the left-out first
    expert lies above the tie band, so ``route_gap`` counts it."""
    from modular_rag_system_tpu_torch.models import deepseek_v3

    monkeypatch.setattr(deepseek_v3, "route", _drop_top_route)
    rc, out = _run(capsys, seed=13)
    assert rc == 0 and out["correct"] is False, out["checks"]
    assert out["checks"]["route_gap"]["value"] > out["checks"]["route_gap"]["limit"]


def test_sections_lengths():
    """The cell's sections at the published vocab: 256 to 4,096 tokens,
    [CLS] and [SEP] included, spread evenly, distinct, and each call's
    longest within a piece of 4,096 (so every call pads to one bucket)."""
    import itertools

    import numpy as np

    from portbench import data

    kind = common.traffic("ingest_moe")
    cfg = common.config("moonlight-16b-a3b")
    mix = common.mix("ingest-sections16")
    tok = kind._tokenizer(cfg)
    got = []
    for b in itertools.islice(kind.sections(data.torch_seed(3, "window"), mix["batch"],
                                            mix["tokens_min"], mix["tokens_max"], tok), 4):
        n = [len(tok.ids(c)) for c, _ in b]
        assert len({c for c, _ in b}) == len(b) == 16
        assert min(n) >= 256 and 4092 <= max(n) <= 4096
        got += n
    assert 1900 < float(np.median(got)) < 2450


def test_a_weighting_fault_shows_in_the_gaps(capsys, monkeypatch):
    """The routed experts' weights without ``routed_scaling_factor``: the
    same experts, so ``route_gap`` stays near 0, and the gaps grow far past
    the sound run's at this seed (the limits are set at the published
    size, where the gaps of a sound run are larger; at this size the
    fault's gaps read 7x and more the sound run's bf16 ones)."""
    from modular_rag_system_tpu_torch.models import deepseek_v3

    rc, sound = _run(capsys, seed=13)
    orig = deepseek_v3.route
    monkeypatch.setattr(deepseek_v3, "route",
                        lambda logits, bias, k, scaling: orig(logits, bias, k, 1.0))
    rc, out = _run(capsys, seed=13)
    assert rc == 0
    for name in ("row_gap", "token_gap"):
        assert out["checks"][name]["value"] > 5 * sound["checks"][name]["value"], name


def test_a_program_without_the_module_fails_at_once(monkeypatch, tmp_path):
    import builtins

    from portbench.run import Run

    real = builtins.__import__

    def no_module(name, globals=None, locals=None, fromlist=(), level=0):
        if name.endswith("models") and fromlist and "deepseek_v3" in fromlist:
            raise ImportError("no deepseek_v3")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_module)
    cell = common.cell(CELL)
    run = Run(SimpleNamespace(seed=1, seconds=1.0, workload=CELL), cell,
              common.config(cell["config"]), common.mix(cell["traffic"]),
              torch.device("cpu"), tmp_path)
    with pytest.raises(ImportError):
        common.traffic("ingest_moe").setup(run)
    assert not (tmp_path / "checkpoint").exists()


# ---------------------------------------------------------------------------
def test_forward_flops_at_the_published_widths():
    cfg = common.config("moonlight-16b-a3b")["hf_config"]
    assert ds_roof.attention_weights(cfg) == 13_762_560
    # 2.24B active weights a token: 27 attention blocks, the dense layer's
    # 11,264-wide SwiGLU, 26 x (router, 6 routed and 2 shared experts)
    assert ds_roof.active_weights(cfg) == 2_243_559_424
    n = 2300
    flops = ds_roof.forward_flops(cfg, [n])
    attn = 27 * 16 * 640 * n * (n + 1) // 2
    assert flops == 2 * 2_243_559_424 * n + attn
    # the experts are about three quarters of the work at these lengths
    experts = 26 * 8 * 3 * 2048 * 1408 * 2 * n
    assert 0.7 < experts / flops < 0.8


def test_causal_bound_at_the_cell_shape():
    spec = SPECS["H100"]
    pairs, rows = 16 * 16 * 27 * (2300 * 2301 // 2), 16 * 16 * 27 * 2300
    t = mea_causal.bound_s(pairs, rows, 192, 128, spec)
    assert t == mea_causal.ops(pairs, 192, 128) / spec["bf16"]  # operations bound it
    assert mea_causal.nbytes(1, 192, 128) == 1280


def test_causal_reader_picks_its_kernel_by_name():
    reader = common.layer("moedoc.attn_causal_roofline")
    name = ("void (anonymous namespace)::mea_causal_kernel<192, 128, 64, 4>(unsigned short "
            "const*, unsigned short const*, float, int)")
    assert reader.is_causal(name)
    assert not reader.is_causal("void (anonymous namespace)::mea_bf16_kernel<64, 64, 4, false>")
    from portbench import kernel_share

    assert kernel_share.mea_mode(name) is None  # no ModernBERT reader counts it
    hf = common.config("moonlight-16b-a3b")["hf_config"]
    run = SimpleNamespace(state={"kernel_share": {"encoder.attn_causal_pairs": 10 ** 12,
                                                  "encoder.attn_causal_rows": 10 ** 6}},
                          spec=SPECS["H100"], config={"hf_config": hf})
    trace = {"kernels": {name: (1.0, 27)}}
    want = 100 * mea_causal.bound_s(10 ** 12, 10 ** 6, 192, 128, SPECS["H100"])
    assert reader.read(run, None, trace) == pytest.approx(want)
    assert reader.read(run, None, None) is None
