"""DeepSeek-V3 (Moonlight-16B-A3B's block) on the port's encoder path, on
the CPU at a small size.

A seeded DeepSeek-V3 of the published structure (1 dense and 2 expert
layers; 8 routed experts, 2 a token, 1 shared; MLA with q and k 24 wide
(16 + 8 RoPE) and v 16 wide; hidden 32, 2 heads, vocab 512) is written as
a local BF16 HF checkpoint, loaded through ``hf_loader`` and held against
``portbench/reference/deepseek_v3.py``, whose equations are held against
transformers' ``DeepseekV3Model``.  Tolerances and their reasons:

* the reference against ``DeepseekV3Model`` (eager attention), f32: the
  same operations, the experts summed in another order: 1e-5;
* the port against the reference, f32 on both sides: the same operations
  in another order (packed tokens, the experts' rows sorted, the combine
  slot by slot): each component of a unit row, and of a final hidden
  state, within 1e-5;
* bf16: every operand, activation and residual sum rounded to bf16 (2^-8
  relative) in each of the three layers: unit rows within 0.01 in L2 (a
  few rounding steps of 2^-8, measured 0.0045), final states within 0.01
  RMS (measured 0.0040);
* the causal mode's plain version against a dense masked softmax: f32
  within 1e-6; bf16 rounds each probability before it multiplies v (2^-9
  of max |v| at most) and the output (2^-9 of it): |d| <= 2^-8 (max|v| +
  |ref|) + 1e-6;
* the plain ``rescan`` and ``fused_topk`` at d = 2,048 on small-integer
  rows and queries (every sum exact in f32): equal to a brute-force top-k,
  ties to the smallest row id.
"""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from modular_rag_system_tpu_torch.config import RAGConfig
from modular_rag_system_tpu_torch.models import build_encoder
from modular_rag_system_tpu_torch.models import deepseek_v3 as dsv3
from modular_rag_system_tpu_torch.models import hf_loader as H
from modular_rag_system_tpu_torch.models.default_ckpt import ASSET_DIR
from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder
from modular_rag_system_tpu_torch.models.pooling import pool
from modular_rag_system_tpu_torch.ops import binmax_topk as pb
from modular_rag_system_tpu_torch.ops import fused_topk as pf
from modular_rag_system_tpu_torch.ops import moe_grouped as mg
from modular_rag_system_tpu_torch.ops.flash_attention import (
    mea_attention,
    mea_attention_reference,
)
from modular_rag_system_tpu_torch.utils.profiling import TRACER
from portbench.reference import deepseek_v3 as ref
from portbench.reference.wordpiece import WordPiece, load_vocab

CFG = {"model_type": "deepseek_v3", "vocab_size": 512, "hidden_size": 32,
       "num_hidden_layers": 3, "num_attention_heads": 2, "num_key_value_heads": 2,
       "intermediate_size": 48, "moe_intermediate_size": 16, "n_routed_experts": 8,
       "num_experts_per_tok": 2, "n_shared_experts": 1, "first_k_dense_replace": 1,
       "kv_lora_rank": 16, "q_lora_rank": None, "qk_nope_head_dim": 16,
       "qk_rope_head_dim": 8, "v_head_dim": 16, "n_group": 1, "topk_group": 1,
       "norm_topk_prob": True, "routed_scaling_factor": 2.446, "rms_norm_eps": 1e-5,
       "rope_theta": 50000, "max_position_embeddings": 256, "rope_interleave": True,
       "hidden_act": "silu", "scoring_func": "sigmoid", "topk_method": "noaux_tc",
       "moe_layer_freq": 1, "attention_bias": False, "tie_word_embeddings": False}
MOE_LAYERS = CFG["num_hidden_layers"] - CFG["first_k_dense_replace"]
# 4, 9, 12, 47 and 3 tokens
TEXTS = ["the cell", "energy from the ocean water and the wind",
         "the mitochondria is the powerhouse of the cell",
         "hurricanes draw their energy from warm ocean water , and the storms grow " * 3,
         "a"]


def _vocab():
    full = load_vocab(ASSET_DIR / "vocab.txt")
    return {p: i for p, i in full.items() if i < CFG["vocab_size"]}


def _weights(seed=5):
    return ref.random_weights(CFG, seed, "cpu")


def _write(d, weights, cfg=CFG, dtype=torch.bfloat16, prefix="model."):
    d.mkdir(parents=True, exist_ok=True)
    (d / "config.json").write_text(json.dumps(cfg))
    v = _vocab()
    (d / "vocab.txt").write_text("".join(p + "\n" for p, _ in
                                         sorted(v.items(), key=lambda kv: kv[1])))
    H.write_safetensors(d / "model.safetensors",
                        {prefix + k.removeprefix("model."): t.to(dtype) for k, t in weights.items()})
    return d


def _encoder(ckpt, impl="dense", dtype="float32", batch_size=8):
    cfg = RAGConfig.load(overrides={
        "embedding.hf_checkpoint": str(ckpt), "embedding.dim": CFG["hidden_size"],
        "embedding.lexical_dim": 0, "embedding.max_seq_len": 128,
        "embedding.attention_impl": impl, "embedding.dtype": dtype,
        "embedding.batch_size": batch_size})
    return build_encoder(cfg, device="cpu")


def _ids(texts):
    tok = WordPiece(_vocab(), 128)
    return [ref.ids_of(tok, t, "cpu") for t in texts]


def _program(enc, texts):
    """(unit rows, packed final states, per expert layer the (N, k)
    experts per text) of the port, the texts in one batch."""
    seen, routes = {}, []
    orig = dsv3.route

    def recording(*args):
        idx, w = orig(*args)
        routes.append(idx)
        return idx, w

    hook = enc.module.final_norm.register_forward_hook(lambda m, a, out: seen.update(h=out))
    dsv3.route = recording
    try:
        rows = enc.encode_device(texts)
    finally:
        dsv3.route = orig
        hook.remove()
    cuts = np.cumsum([0] + [len(i) for i in _ids(texts)]).tolist()
    follow = [[r[s:e] for s, e in zip(cuts[:-1], cuts[1:])] for r in routes]
    return rows, seen["h"], follow


# ---------------------------------------------------------------------------
# the reference's equations
def test_reference_matches_transformers_deepseek_v3():
    transformers = pytest.importorskip("transformers")
    keep = {k: v for k, v in CFG.items()
            if k not in ("model_type", "scoring_func", "topk_method", "moe_layer_freq")}
    model = transformers.DeepseekV3Model(
        transformers.DeepseekV3Config(**keep, attn_implementation="eager")).eval()
    w = _weights()
    assert not model.load_state_dict({k.removeprefix("model."): v for k, v in w.items()},
                                     strict=True).missing_keys
    for ids in _ids(TEXTS[2:4]):
        with torch.no_grad():
            want = model(input_ids=ids[None]).last_hidden_state[0]
        assert (ref.hidden(w, CFG, ids) - want).abs().max().item() <= 1e-5


def test_reference_follows_routes_within_the_band_only():
    w = _weights()
    ids = _ids(TEXTS[3:4])
    own = ref.routes(w, CFG, ids[0])
    assert len(own) == MOE_LAYERS and own[0].shape == (len(ids[0]), 2)
    # its own choice: no fault
    _, stats = ref.hidden_many(w, CFG, ids, follow=[[r] for r in own])
    assert stats == {"faults": 0, "choices": MOE_LAYERS * 2 * len(ids[0])}
    # experts 6 and 7 for every token: faults where they lie below the band
    worst = [[torch.tensor([6, 7]).expand_as(r)] for r in own]
    _, bad = ref.hidden_many(w, CFG, ids, follow=worst)
    assert bad["faults"] > 0


def _drop_top(logits, bias, top_k, scaling):
    """The program's router off by one rank: ranks 2..k + 1, not 1..k."""
    s = torch.sigmoid(logits)
    idx = torch.sort(s + bias, dim=1, descending=True, stable=True).indices[:, 1:top_k + 1]
    w = s.gather(1, idx)
    return idx, w / w.sum(dim=1, keepdim=True) * scaling


def test_reference_counts_a_left_out_top_expert(tmp_path, monkeypatch):
    """A program that chooses ranks 2..k + 1: the k + 1-th expert lies
    near the k-th, but the left-out first lies above the band.  The
    reference counts it and keeps its own choice, so that its rows are
    about those of the sound model, far from the program's."""
    w = _weights()
    enc = _encoder(_write(tmp_path / "ck", w))
    monkeypatch.setattr(dsv3, "route", _drop_top)
    rows, _, follow = _program(enc, TEXTS)
    ids = _ids(TEXTS)
    states, stats = ref.hidden_many(w, CFG, ids, follow=follow)
    own, _ = ref.hidden_many(w, CFG, ids)
    n = sum(len(i) for i in ids)
    assert stats["choices"] == MOE_LAYERS * 2 * n
    assert stats["faults"] > n  # in each layer, most tokens' first expert left out
    want = torch.stack([ref.pooled(x) for x in own])
    kept = torch.linalg.vector_norm(torch.stack([ref.pooled(x) for x in states]) - want, dim=1)
    off = torch.linalg.vector_norm(rows - want, dim=1)
    # measured: kept 0 but 5.9e-4 on one text (a token or two within the
    # band followed), off 0.051-0.072
    assert kept.max().item() < 0.1 * off.min().item()


# ---------------------------------------------------------------------------
# the port against the reference
@pytest.mark.parametrize("impl", ["dense", "flash"])
@pytest.mark.parametrize("prefix", ["model.", ""])
def test_port_matches_reference_f32(tmp_path, impl, prefix):
    w = _weights()
    enc = _encoder(_write(tmp_path / "ck", w, prefix=prefix), impl)
    assert isinstance(enc.module, dsv3.DeepseekV3Module) and enc.model_type == "deepseek_v3"
    assert enc.name == "deepseek_v3-l3-h32" and enc.params is None
    rows, states, follow = _program(enc, TEXTS)
    want_states, stats = ref.hidden_many(w, CFG, _ids(TEXTS), follow=follow)
    assert stats["faults"] == 0
    want = torch.stack([ref.pooled(s) for s in want_states])
    assert (rows - want).abs().max().item() <= 1e-5
    assert (states - torch.cat(want_states)).abs().max().item() <= 1e-5


def test_port_matches_reference_bf16(tmp_path):
    w = _weights()
    enc = _encoder(_write(tmp_path / "ck", w), dtype="bfloat16")
    assert all(p.dtype == torch.bfloat16 for n, p in enc.module.named_parameters()
               if not n.endswith("norm.weight"))
    rows, states, follow = _program(enc, TEXTS)
    want_states, stats = ref.hidden_many(w, CFG, _ids(TEXTS), follow=follow)
    assert stats["faults"] == 0  # route_gap reads 0 on the program
    want = torch.stack([ref.pooled(s) for s in want_states])
    assert torch.linalg.vector_norm(rows - want, dim=1).max().item() <= 0.01
    d = torch.linalg.vector_norm(states - torch.cat(want_states), dim=1)
    assert d.square().mean().sqrt().item() / math.sqrt(CFG["hidden_size"]) <= 0.01


def test_routing_faults_show(tmp_path, monkeypatch):
    """Softmax scores in the program's place: its choices fall below the
    reference's tie band."""
    w = _weights()
    enc = _encoder(_write(tmp_path / "ck", w))

    def softmax_route(logits, bias, top_k, scaling):
        s = torch.softmax(logits, dim=1)
        idx = torch.sort(s + bias, dim=1, descending=True, stable=True).indices[:, :top_k]
        g = s.gather(1, idx)
        return idx, g / g.sum(dim=1, keepdim=True) * scaling

    monkeypatch.setattr(dsv3, "route", softmax_route)
    rows, _, follow = _program(enc, TEXTS)
    _, stats = ref.hidden_many(w, CFG, _ids(TEXTS), follow=follow)
    assert stats["faults"] > 0


def test_route_ties_go_to_the_smaller_expert():
    logits = torch.zeros((3, 8))
    bias = torch.zeros(8)
    idx, w = dsv3.route(logits, bias, 2, 2.0)
    assert idx.tolist() == [[0, 1]] * 3
    assert torch.allclose(w, torch.ones(3, 2))
    bias[5] = 0.1
    idx, w = dsv3.route(logits, bias, 2, 2.0)
    # chosen by score + bias, weighted by the score alone
    assert idx.tolist() == [[5, 0]] * 3 and torch.allclose(w, torch.ones(3, 2))


def test_expert_layer_routes_only_live_tokens(tmp_path):
    enc = _encoder(_write(tmp_path / "ck", _weights()), "flash")
    TRACER.reset()
    TRACER.enable()
    try:
        enc.encode_device(TEXTS)
        counts, totals = TRACER.counters(), TRACER.totals()
    finally:
        TRACER.disable()
        TRACER.reset()
    n = [len(i) for i in _ids(TEXTS)]
    L, heads = CFG["num_hidden_layers"], CFG["num_attention_heads"]
    assert counts["encoder.attn_causal_pairs"] == L * heads * sum(m * (m + 1) // 2 for m in n)
    assert counts["encoder.attn_causal_rows"] == L * heads * sum(n)
    assert counts["encoder.moe_rows"] == MOE_LAYERS * sum(n)
    assert counts["encoder.moe_pairs"] == 2 * counts["encoder.moe_rows"]
    assert totals["encoder.attn_causal"][1] == L
    assert totals["encoder.moe_experts"][1] == MOE_LAYERS
    assert totals["encoder.moe_route"][1] == 2 * MOE_LAYERS
    # the grouped SwiGLU calls' rows: each expert layer's routed pairs and
    # its shared experts' rows, and the dense layers' rows
    dense = CFG["first_k_dense_replace"]
    assert counts["encoder.moe_grouped_rows"] == \
        MOE_LAYERS * (CFG["num_experts_per_tok"] + 1) * sum(n) + dense * sum(n)
    # nothing reads the experts' counts back to the host
    assert "encoder.moe_counts" not in totals


# ---------------------------------------------------------------------------
# the grouped SwiGLU calls' plain versions against the per-expert loop
def _loop_experts(rows, w13, w2, counts):
    """The expert layer's SwiGLUs as one loop over the experts' counts, each
    expert's rows through the library's GEMMs, SwiGLU in f32 between them."""
    ys = torch.empty_like(rows)
    at = 0
    for e, c in enumerate(counts):
        if c:
            g, u = F.linear(rows[at:at + c], w13[e]).chunk(2, dim=-1)
            a = (F.silu(g.float()) * u.float()).to(rows.dtype)
            torch.mm(a, w2[e].t(), out=ys[at:at + c])
        at += c
    return ys


def _loop_dense(x, w13, w2):
    g, u = F.linear(x, w13).chunk(2, dim=-1)
    return F.linear((F.silu(g.float()) * u.float()).to(x.dtype), w2)


# counts of 6 experts: ragged (no multiple of any tile, one expert empty),
# one expert taking every row, no row at all
GROUPS = {"ragged": [3, 0, 129, 1, 64, 7], "one_takes_all": [0, 0, 0, 200, 0, 0],
          "empty": [0] * 6}


def _grouped_case(counts, dtype, K=256, D=128, H=256, seed=4):
    g = torch.Generator().manual_seed(seed)
    E, P = len(counts), sum(counts)
    rows = torch.randn((P, K), generator=g).to(dtype)
    w13 = (torch.randn((E, 2 * D, K), generator=g) * 0.1).to(dtype)
    w2 = (torch.randn((E, H, D), generator=g) * 0.1).to(dtype)
    offsets = torch.tensor(np.concatenate(([0], np.cumsum(counts))), dtype=torch.int32)
    return rows, w13, w2, offsets


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", sorted(GROUPS))
def test_grouped_swiglu_equals_the_expert_loop(dtype, case):
    counts = GROUPS[case]
    rows, w13, w2, offsets = _grouped_case(counts, dtype)
    act = mg.gate_up(rows, w13, offsets)
    assert act.shape == (sum(counts), 128) and act.dtype == dtype
    got = mg.down(act, w2, offsets)
    assert torch.equal(got, _loop_experts(rows, w13, w2, counts))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("P", [0, 1, 77])
def test_one_group_equals_the_dense_swiglu(dtype, P):
    rows, w13, w2, _ = _grouped_case([P], dtype)
    assert torch.equal(mg.down(mg.gate_up(rows, w13[0]), w2[0]),
                       _loop_dense(rows, w13[0], w2[0]))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_down_stores_each_row_at_its_pair(dtype):
    g = torch.Generator().manual_seed(6)
    N, k, E = 70, 6, 8
    flat = torch.randint(0, E, (N * k,), generator=g)
    flat[:N] = 2  # a crowded expert; others may be empty
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=E).tolist()
    rows, w13, w2, offsets = _grouped_case(counts, dtype, seed=7)
    ys = _loop_experts(rows, w13, w2, counts)
    want = torch.empty_like(ys)
    want[order] = ys
    got = mg.down(mg.gate_up(rows, w13, offsets), w2, offsets, dest=order)
    assert torch.equal(got, want)


def _loop_expert_layer(layer, h):
    """The expert layer with its SwiGLUs as the per-expert loop (the counts
    read on the host), the rows put back by their pairs."""
    N, k = h.shape[0], layer.top_k
    idx, w = dsv3.route(F.linear(h.float(), layer.gate.float()), layer.bias, k, layer.scaling)
    flat = idx.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=layer.experts).tolist()
    ys = _loop_experts(h[order // k], layer.w13.to(h.dtype), layer.w2.to(h.dtype), counts)
    out = _loop_dense(h, layer.shared.w13.to(h.dtype), layer.shared.w2.to(h.dtype)).float()
    by_pair = torch.empty_like(ys)
    by_pair[order] = ys
    by_pair = by_pair.view(N, k, -1)
    for j in range(k):
        out += w[:, j:j + 1] * by_pair[:, j].float()
    return out.to(h.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_layer_equals_the_loop(dtype):
    g = torch.Generator().manual_seed(9)
    layer = dsv3.Experts(32, 16, 8, 2, 1, 2.446, dtype)
    with torch.no_grad():
        for p in layer.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.3)
        layer.bias.copy_(torch.randn(8, generator=g) * 0.05)
        h = torch.randn((41, 32), generator=g).to(dtype)
        assert torch.equal(layer(h), _loop_expert_layer(layer, h))


def test_grouped_calls_refuse_what_the_kernel_does_not_tile():
    x = torch.zeros((8, 128), dtype=torch.bfloat16)
    w = torch.zeros((2, 256, 128), dtype=torch.bfloat16)
    off = torch.tensor([0, 3, 8], dtype=torch.int32)
    mg._check("gate_up", x, w, off, 128, 256, 256)  # the kernel's shapes pass
    with pytest.raises(ValueError, match="bf16"):
        mg._check("gate_up", x.float(), w, off, 128, 256, 256)
    with pytest.raises(ValueError, match="depth % 64"):
        mg._check("gate_up", x[:, :96].contiguous(), w[..., :96].contiguous(), off, 96, 256,
                  256)
    with pytest.raises(ValueError, match="widths % 256"):
        mg._check("down", x, w[:, :128].contiguous(), off, 128, 128, 256)
    with pytest.raises(ValueError, match="weights"):
        mg._check("gate_up", x, w[:1], off, 128, 256, 256)
    with pytest.raises(ValueError, match="int32"):
        mg._check("gate_up", x, w, off.long(), 128, 256, 256)


def test_experts_roofline_reads_the_grouped_kernels_work():
    """``moedoc.experts_roofline``: the SwiGLU GEMMs' operations from the
    counters over the grouped kernels' device time, by their name; nothing
    where the program has no grouped kernel or counter."""
    from types import SimpleNamespace

    from portbench import common

    reader = common.layer("moedoc.experts_roofline")
    hf = common.config("moonlight-16b-a3b")["hf_config"]
    # one call of 34,800 live tokens: 26 expert layers, 1 dense
    n = 34_800
    c = {"encoder.moe_rows": 26 * n, "encoder.moe_pairs": 26 * 6 * n,
         "encoder.moe_grouped_rows": 26 * 6 * n + 26 * n + n}
    flops = reader.swiglu_flops(hf, c["encoder.moe_pairs"], c["encoder.moe_rows"],
                                c["encoder.moe_grouped_rows"])
    # routed 6 x 1,408 and shared 2 x 1,408 a token and expert layer, the
    # dense layer's 11,264: 2 x 2,048 x 3 x that
    assert flops == 2 * 2048 * 3 * n * (26 * (6 * 1408 + 2 * 1408) + 11264)
    names = ("void (anonymous namespace)::moe_grouped_kernel<true>(CUtensorMap_st, "
             "CUtensorMap_st, int const*, long long const*, unsigned short*, int, int, int, "
             "int, int)", "void (anonymous namespace)::moe_grouped_kernel<false>(...)")
    assert all(reader.is_grouped(x) for x in names)
    assert not reader.is_grouped("nvjet_tst_256x160_64x4_1x2_h_bz_coopA_TNT")
    spec = common.SPECS["H100"]
    run = SimpleNamespace(state={"kernel_share": c}, spec=spec, config={"hf_config": hf})
    trace = {"kernels": {names[0]: (0.1, 27), names[1]: (0.05, 27), "other": (9.0, 1)}}
    assert reader.read(run, None, trace) == pytest.approx(100 * flops / spec["bf16"] / 0.15)
    assert reader.read(run, None, {"kernels": {"other": (9.0, 1)}}) is None  # no such kernel
    run.state = {"kernel_share": {k: v for k, v in c.items() if k != "encoder.moe_grouped_rows"}}
    assert reader.read(run, None, trace) is None  # no such counter


def test_trainer_refuses_deepseek_v3(tmp_path):
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer

    enc = _encoder(_write(tmp_path / "ck", _weights()))
    with pytest.raises(ValueError, match="BERT-class"):
        ContrastiveTrainer(enc)


# ---------------------------------------------------------------------------
# pooling
def test_last_pooling_takes_the_last_live_token():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((4, 6, 5), generator=g)
    mask = torch.tensor([[1, 1, 1, 0, 0, 0], [1, 1, 1, 1, 1, 1], [0, 1, 1, 0, 1, 0],
                         [0, 0, 0, 0, 0, 0]])
    got = pool(x, mask, "last")
    for b, at in ((0, 2), (1, 5), (2, 4)):
        want = x[b, at] / x[b, at].norm()
        assert torch.allclose(got[b], want)
    assert (got[3] == 0).all()  # no live token
    m = mask.float()[..., None]
    mean = (x * m).sum(1) / m.sum(1).clamp(min=1.0)
    assert torch.equal(pool(x, mask), mean / mean.norm(dim=-1, keepdim=True).clamp(min=1e-12))
    with pytest.raises(ValueError, match="pooling"):
        pool(x, mask, "max")
    assert dsv3.DeepseekV3Module.pooling == "last"


# ---------------------------------------------------------------------------
# the loader
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_loader_fills_the_module_tensor_by_tensor(tmp_path, dtype):
    w = _weights()
    d = _write(tmp_path / "ck", w, dtype=dtype)
    fill, vocab, arch = H.load_checkpoint(local_dir=str(d))
    assert callable(fill) and arch["model_type"] == "deepseek_v3"
    assert arch["layout"]["interleave"] and arch["layout"]["top_k"] == 2
    enc = MiniLMEncoder(state_dict=fill, dim=32, max_seq_len=128, dtype="bfloat16",
                        num_layers=3, num_heads=2, mlp_dim=48, vocab_size=512, device="cpu",
                        model_type="deepseek_v3", layout=arch["layout"])
    m = enc.module
    assert torch.equal(m.tok_embed.weight, w["model.embed_tokens.weight"].to(torch.bfloat16))
    e3 = m.blocks[2].mlp
    assert torch.equal(e3.w13[5, :16], w["model.layers.2.mlp.experts.5.gate_proj.weight"]
                       .to(torch.bfloat16))
    assert torch.equal(e3.w13[5, 16:], w["model.layers.2.mlp.experts.5.up_proj.weight"]
                       .to(torch.bfloat16))
    assert torch.equal(e3.shared.w2, w["model.layers.2.mlp.shared_experts.down_proj.weight"]
                       .to(torch.bfloat16))
    assert torch.equal(e3.bias, w["model.layers.2.mlp.gate.e_score_correction_bias"])
    assert torch.equal(m.blocks[0].mlp.w13[48:], w["model.layers.0.mlp.up_proj.weight"]
                       .to(torch.bfloat16))
    assert e3.bias.dtype == torch.float32 and m.final_norm.weight.dtype == torch.float32


def test_loader_skips_the_lm_head_and_refuses_the_rest(tmp_path):
    w = _weights()
    extra = dict(w, **{"lm_head.weight": torch.zeros(512, 32)})
    enc = _encoder(_write(tmp_path / "a", extra))
    assert enc.encode_device(TEXTS[:1]).shape == (1, 32)
    unknown = dict(w, **{"model.layers.1.mlp.experts.9.up_proj.weight": torch.zeros(16, 32)})
    with pytest.raises(ValueError, match="not computed"):
        _encoder(_write(tmp_path / "b", unknown))
    missing = {k: v for k, v in w.items() if "experts.3.down_proj" not in k}
    with pytest.raises(KeyError, match="fills"):
        _encoder(_write(tmp_path / "c", missing))
    wrong = dict(w, **{"model.norm.weight": torch.ones(33)})
    with pytest.raises(ValueError, match="is \\(33,\\)"):
        _encoder(_write(tmp_path / "d", wrong))


@pytest.mark.parametrize("change", [{"q_lora_rank": 8}, {"rope_scaling": {"type": "yarn"}},
                                    {"n_group": 2}, {"scoring_func": "softmax"},
                                    {"norm_topk_prob": False}, {"hidden_act": "gelu"},
                                    {"attention_bias": True}, {"topk_method": "greedy"}])
def test_loader_refuses_what_it_does_not_compute(tmp_path, change):
    d = _write(tmp_path / "ck", _weights(), cfg=dict(CFG, **change))
    with pytest.raises(ValueError, match="do not compute"):
        H.load_checkpoint(local_dir=str(d))


def test_safetensors_read_one_tensor_at_a_time(tmp_path):
    g = torch.Generator().manual_seed(1)
    ts = {"a": torch.randn((3, 4), generator=g).to(torch.bfloat16),
          "b": torch.randn(5, generator=g).to(torch.float16), "c": torch.randn(2, generator=g)}
    H.write_safetensors(tmp_path / "m.safetensors", ts)
    got = dict(H.iter_safetensors(tmp_path / "m.safetensors"))
    assert all(torch.equal(got[k], ts[k]) and got[k].dtype == ts[k].dtype for k in ts)
    f32 = H.read_safetensors(tmp_path / "m.safetensors", names={"a", "c"})
    assert set(f32) == {"a", "c"} and torch.equal(f32["a"], ts["a"].float())


# ---------------------------------------------------------------------------
# the causal mode's plain version
def _dense_causal(q, k, v, pad):
    B, L, Hh, dqk = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(dqk)
    s = torch.where(pad.bool()[:, None, None, :], s, -1e9)
    i = torch.arange(L)
    s = s.masked_fill(i[None, :] > i[:, None], float("-inf"))
    m = s.amax(-1, keepdim=True)
    e = torch.exp(s - m)
    o = torch.einsum("bhqk,bkhd->bqhd", e.to(v.dtype).float(), v.float())
    o = o / e.sum(-1).transpose(1, 2)[..., None]
    dead = (m == -1e9).squeeze(-1).transpose(1, 2)[..., None] | ~pad.bool()[:, :, None, None]
    return torch.where(dead, 0.0, o)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,dqk,dv", [(1, 24, 16), (37, 24, 16), (300, 192, 128), (600, 64, 64)])
def test_causal_reference_matches_dense_softmax(dtype, L, dqk, dv):
    g = torch.Generator().manual_seed(2)
    B, Hh = 3, 2
    q, k = (torch.randn((B, L, Hh, dqk), generator=g).to(dtype) for _ in range(2))
    v = torch.randn((B, L, Hh, dv), generator=g).to(dtype)
    pad = torch.ones((B, L), dtype=torch.int32)
    pad[0, L * 5 // 8 + 1:] = 0
    pad[1, : L // 3] = 0  # leading padding: rows with no live key in their range
    out = mea_attention(q, k, v, pad, causal=True)
    assert out.shape == (B, L, Hh, dv) and out.dtype == dtype
    want = _dense_causal(q, k, v, pad)
    d = (out.float() - want).abs()
    tol = 1e-6 if dtype == torch.float32 else \
        2.0**-8 * (v.float().abs().max() + want.abs()) + 1e-6
    assert (d <= tol).all(), d.max().item()
    assert (out[~pad.bool()] == 0).all()


def test_causal_mode_takes_no_window():
    q = torch.zeros((1, 4, 1, 8))
    with pytest.raises(ValueError, match="no window"):
        mea_attention(q, q, q, torch.ones((1, 4)), window=2, causal=True)
    assert mea_attention_reference(q, q, q[..., :4], torch.ones((1, 4)), causal=True).shape == \
        (1, 4, 1, 4)


# ---------------------------------------------------------------------------
# the plain two-pass stages at d = 2,048
def _brute_topk(E, q, count, k):
    """Scores of bf16-rounded small integers (exact), top k, ties to the
    smallest id."""
    s = q.to(torch.bfloat16).double() @ E.to(torch.bfloat16).double().T
    s[:, count:] = -math.inf
    ids = np.arange(s.shape[1])
    out_v, out_i = [], []
    for row in s.numpy():
        order = np.lexsort((ids, -row))[:k]
        out_v.append(row[order])
        out_i.append(np.where(np.isfinite(row[order]), order, -1))
    return torch.tensor(np.array(out_v)).float(), torch.tensor(np.array(out_i)).int()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_fused_topk_and_rescan_at_2048(dtype):
    d, cap, count, k, bw = 2048, 512, 500, 12, 32
    rng = np.random.default_rng(3)
    E = torch.from_numpy(rng.integers(-1, 2, (cap, d)).astype(np.float32))
    E[count:] = 0
    E[7], E[300] = E[3], E[3]  # exact ties
    q = torch.from_numpy(rng.integers(-1, 2, (5, d)).astype(np.float32))
    q[0] = E[3]
    E = E.to(dtype)
    want_v, want_i = _brute_topk(E, q, count, k)
    v, i = pf.fused_topk_reference(E, count, q, k)
    assert torch.equal(v, want_v) and torch.equal(i, want_i)
    assert want_i[0, :3].tolist() == [3, 7, 300]
    # every bin listed: rescan's plain version gives the same
    bins = torch.arange(cap // bw, dtype=torch.int32).repeat(5, 1)
    v, i = pb.rescan_reference(E, bins, count, q, k, bw)
    assert torch.equal(v, want_v) and torch.equal(i, want_i)


# ---------------------------------------------------------------------------
# the engine on a tiny DeepSeek-V3 checkpoint
def test_engine_adds_and_answers(tmp_path):
    from modular_rag_system_tpu_torch.engine import RAGEngine
    from modular_rag_system_tpu_torch.types import Document

    w = _weights()
    cfg = RAGConfig.load(overrides={
        "embedding.hf_checkpoint": str(_write(tmp_path / "ck", w)),
        "embedding.dim": CFG["hidden_size"], "embedding.lexical_dim": 0,
        "embedding.max_seq_len": 128, "embedding.attention_impl": "flash",
        "embedding.dtype": "float32", "index.tier": "exact",
        "store.storage_path": str(tmp_path / "store"), "store.snapshot_on_shutdown": False,
        "retrieval.similarity_threshold": 0.0, "retrieval.time_weight": 0.0,
        "serving.file_server_port": 0})
    eng = RAGEngine(cfg, device="cpu")
    try:
        ids = eng.add_documents([Document(content=t, source="notes") for t in TEXTS])
        assert eng.index.count == len(TEXTS)
        states, _ = ref.hidden_many(w, CFG, _ids(TEXTS))
        want = torch.stack([ref.pooled(s) for s in states])
        for i, doc_id in enumerate(ids):
            row = eng.store.row_of(doc_id)
            assert (eng.index.E[row].float() - want[i]).abs().max().item() <= 1e-5
        res = eng.query(TEXTS[3], max_results=2)
        assert res.documents[0].content == TEXTS[3]
        batch = eng.query_batch([TEXTS[1], TEXTS[2]], max_results=1)
        assert [r.documents[0].content for r in batch] == [TEXTS[1], TEXTS[2]]
    finally:
        eng.shutdown()
