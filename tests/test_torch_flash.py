"""The port's flash attention path against the JAX package's, on the CPU.

The same numpy inputs go through ``mea_attention`` of both packages: the
JAX Pallas kernel in interpret mode (as ``tests/test_flash_attention.py``
runs it) and the port's plain version, which a CPU tensor selects (the
CUDA kernel is held against that plain version on the card,
``tests/test_torch_kernels.py``).

Tolerances and their reasons:

* f32: both multiply in true f32 on the CPU and differ in summation
  order and in the exp implementation: rtol 2e-4 / atol 2e-5, the JAX
  test's own bar against its dense reference.
* bf16: the same f32 arithmetic, then the probabilities and the output
  are rounded to bf16, so a last-bit difference before a rounding can
  move a value by one bf16 step: |d| <= 2^-7 |ref| + 1e-6; at L = 600
  the live row's outputs get 2^-10 more (see the test).
* Every row is compared, all-padding batch rows included: the JAX
  kernel's padded keys count in such a row's sum (its output is
  sum(v[:L]) / Lp, Lp = L padded as the JAX kernel pads it), and the
  port adds Lp - L to that row's sum.
* The encoder with the bundled checkpoint: f32 embeddings within 1e-5 of
  the JAX flash encoder's (unit vectors; four layers of summation-order
  differences), bf16 cosine >= 0.999 per row as on the dense path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modular_rag_system_tpu.models.default_ckpt import _unflatten
from modular_rag_system_tpu.models.encoder import SentenceEncoderModule as JaxModule
from modular_rag_system_tpu.ops.flash_attention import mea_attention as jax_mea
from modular_rag_system_tpu_torch.config import RAGConfig
from modular_rag_system_tpu_torch.models import build_encoder
from modular_rag_system_tpu_torch.models import tokenizer as ptok
from modular_rag_system_tpu_torch.models.default_ckpt import (
    load_default_assets,
    params_from_flax,
)
from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder, SentenceEncoderModule
from modular_rag_system_tpu_torch.ops.flash_attention import (
    mea_attention,
    mea_attention_reference,
    padded_length,
)

TEXTS = [
    "Hurricanes draw their energy from warm ocean water.",
    "a large automobile",
    "The mitochondria is the powerhouse of the cell!!! (really)",
]


def _qkv(rng, B, L, H, dh):
    return [rng.standard_normal((B, L, H, dh)).astype(np.float32) for _ in range(3)]


def _both(q, k, v, pad, dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    ref = jax_mea(*(jnp.asarray(x).astype(jd) for x in (q, k, v)), jnp.asarray(pad),
                  interpret=True)
    out = mea_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                        torch.from_numpy(pad))
    assert out.dtype == td and out.shape == q.shape
    return np.asarray(ref.astype(jnp.float32)), out.float().numpy()


@pytest.mark.parametrize("dh", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mea_matches_jax(rng, dh, dtype):
    B, L, H = 2, 40, 3
    q, k, v = _qkv(rng, B, L, H, dh)
    pad = np.ones((B, L), np.int32)
    pad[0, 25:] = 0  # ragged padding
    pad[1, 10:] = 0
    ref, out = _both(q, k, v, pad, dtype)
    _assert_close(out, ref, dtype)


def _assert_close(out, ref, dtype, bf16_atol=1e-6):
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)
    else:  # one bf16 step
        d = np.abs(out - ref)
        assert (d <= 2.0**-7 * np.abs(ref) + bf16_atol).all(), d.max()


def test_mea_all_pad_row_is_finite(rng):
    B, L, H, dh = 2, 16, 2, 32
    q, _, _ = _qkv(rng, B, L, H, dh)
    pad = np.zeros((B, L), np.int32)
    pad[0, :5] = 1  # batch row 1 is all padding
    ref, out = _both(q, q, q, pad, "float32")
    assert np.isfinite(out).all() and np.isfinite(ref).all()
    np.testing.assert_allclose(out[0], ref[0], rtol=2e-4, atol=2e-5)
    # the all-padding row equals the JAX kernel's: the sum of v over its L
    # keys divided by the padded length (128 for L = 16)
    np.testing.assert_allclose(out[1], ref[1], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(out[1], np.broadcast_to(q[1].sum(0) / 128, out[1].shape),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("L,Lp", [(16, 128), (600, 1024)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mea_all_pad_row_matches_jax(rng, L, Lp, dtype):
    assert padded_length(L) == Lp
    B, H, dh = 2, 2, 32
    q, k, v = _qkv(rng, B, L, H, dh)
    pad = np.zeros((B, L), np.int32)
    pad[0, : L // 3] = 1  # batch row 1 is all padding
    ref, out = _both(q, k, v, pad, dtype)
    assert np.isfinite(out).all()
    # the live row: over 200 keys a probability p < 1 may round to its other
    # bf16 neighbour after a last-bit difference in exp, which moves an
    # output by 2^-8 p |v| / sum(p), however small the output is
    _assert_close(out[0], ref[0], dtype, bf16_atol=2.0**-10)
    # the all-padding row: every p is exp(0) = 1, exact in both
    _assert_close(out[1], ref[1], dtype)
    vs = torch.from_numpy(v[1]).to(getattr(torch, dtype)).double().sum(0).numpy()
    _assert_close(out[1], np.broadcast_to(vs / Lp, out[1].shape).astype(np.float32), dtype)


def test_mea_length_off_the_tile(rng):
    # L = 100: no multiple of the JAX kernel's 128 lanes or of the port
    # kernel's 64-row tiles; every query row must be covered
    B, L, H, dh = 1, 100, 2, 32
    q, k, v = _qkv(rng, B, L, H, dh)
    ref, out = _both(q, k, v, np.ones((B, L), np.int32), "float32")
    assert np.isfinite(out).all()
    np.testing.assert_allclose(out, ref, rtol=2e-4, atol=2e-5)


def test_mea_is_not_the_dense_arithmetic(rng):
    # keys only are masked: a padded QUERY row still attends to the live
    # keys (the dense path masks query x key and would give it the
    # uniform average)
    B, L, H, dh = 1, 8, 1, 8
    q, k, v = _qkv(rng, B, L, H, dh)
    pad = np.array([[1, 1, 1, 0, 0, 0, 0, 0]], np.int32)
    out = mea_attention_reference(*(torch.from_numpy(x) for x in (q, k, v)),
                                  torch.from_numpy(pad)).numpy()
    s = (q[0, :, 0] @ k[0, :3, 0].T) / np.sqrt(dh)
    p = np.exp(s - s.max(1, keepdims=True))
    want = (p / p.sum(1, keepdims=True)) @ v[0, :3, 0]
    np.testing.assert_allclose(out[0, :, 0], want, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def assets():
    return load_default_assets()


def _forward_both(assets, dtype):
    flat, arch, vocab = assets
    kw = dict(vocab_size=arch["vocab_size"], hidden=arch["hidden"],
              layers=arch["num_layers"], heads=arch["heads"],
              mlp_dim=arch["mlp_dim"], max_len=arch["max_len"])
    # a fourth, all-padding row: what the engine's pow-2 batch padding adds
    ids, mask = ptok.WordPieceTokenizer(vocab, max_len=32).encode_batch(TEXTS + [""])
    ids[3], mask[3] = 0, 0
    jm = JaxModule(dtype=getattr(jnp, dtype), attention_impl="flash", **kw)
    ref = jm.apply({"params": _unflatten(flat)}, jnp.asarray(ids), jnp.asarray(mask))
    out = {}
    for impl in ("flash", "dense"):
        pm = SentenceEncoderModule(dtype=getattr(torch, dtype), attention_impl=impl, **kw)
        pm.load_state_dict(params_from_flax(flat))
        with torch.inference_mode():
            out[impl] = pm(torch.from_numpy(ids).long(), torch.from_numpy(mask)).numpy()
    return np.asarray(ref), out["flash"], out["dense"]


def test_flash_encoder_float32_matches_jax_flash_encoder(assets):
    ref, flash, dense = _forward_both(assets, "float32")
    assert np.isfinite(flash).all()  # the all-padding row too
    np.testing.assert_allclose(flash[:3], ref[:3], rtol=0, atol=1e-5)
    # and the port's dense path: same weights, another arithmetic
    np.testing.assert_allclose(flash[:3], dense[:3], rtol=0, atol=1e-5)


def test_flash_encoder_bfloat16_matches_jax_flash_encoder(assets):
    ref, flash, _ = _forward_both(assets, "bfloat16")
    assert np.isfinite(flash).all()
    cos = np.sum(ref[:3] * flash[:3], axis=1) / (
        np.linalg.norm(ref[:3], axis=1) * np.linalg.norm(flash[:3], axis=1))
    assert cos.min() >= 0.999, cos


def test_build_encoder_flash_plumbing():
    over = {"embedding.dtype": "float32", "embedding.batch_size": 4}
    dense = build_encoder(RAGConfig.load(overrides=over), device="cpu")
    flash = build_encoder(RAGConfig.load(
        overrides={**over, "embedding.attention_impl": "flash"}), device="cpu")
    assert flash.dense.module.attention_impl == "flash"
    assert all(b.attn.attention_impl == "flash" for b in flash.dense.module.blocks)
    assert dense.dense.module.attention_impl == "dense"
    assert flash.name == dense.name and flash.dim == 768
    # three texts pad to a batch of four: the all-padding row must not leak
    e = flash.encode(TEXTS)
    assert e.shape == (3, 768) and np.isfinite(e).all()
    np.testing.assert_allclose(e, dense.encode(TEXTS), rtol=0, atol=1e-5)


def test_attention_impl_validated():
    kw = dict(dim=32, max_seq_len=32, batch_size=2, num_layers=1, num_heads=2,
              mlp_dim=64, vocab_size=500, dtype="float32", device="cpu")
    with pytest.raises(ValueError, match="attention_impl"):
        MiniLMEncoder(state_dict={}, **kw, attention_impl="Flash")
    with pytest.raises(ValueError, match="attention_impl"):
        SentenceEncoderModule(attention_impl="sparse")


# the full mode's two designs on the card: the choice and the kernels' names
def test_full_design_from_the_threshold_on():
    from modular_rag_system_tpu_torch.ops.flash_attention import LONG_FROM, full_design

    bf16, f32 = torch.bfloat16, torch.float32
    assert full_design(LONG_FROM, 64, bf16) == 1 and full_design(8192, 64, bf16) == 1
    assert full_design(LONG_FROM - 1, 64, bf16) == 0 and full_design(32, 64, bf16) == 0
    # only bf16, only dh 64
    for dh in (8, 32, 48, 128):
        assert full_design(8192, dh, bf16) == 0
    for dtype in (f32, torch.float16):
        assert full_design(8192, 64, dtype) == 0


@pytest.mark.parametrize("name,mode", [
    # the names torch.profiler printed for the Hopper design's two kernels on
    # an H100, and for the tile template's full and window modes
    ("void (anonymous namespace)::hopper::mea_bf16_kernel<64, 128, false>(CUtensorMap_st, "
     "CUtensorMap_st, CUtensorMap_st, float const*, unsigned short*, int, int, float)", "full"),
    ("void (anonymous namespace)::hopper::key_bounds::mea_bf16_kernel<64, 128, false>("
     "unsigned short const*, float const*, float*, int, int, float)", "full"),
    ("void (anonymous namespace)::mea_bf16_kernel<64, 64, 4, false>(unsigned short const*, "
     "unsigned short const*, unsigned short const*, float const*, unsigned short*, int, int, "
     "int, int, float, int)", "full"),
    ("void (anonymous namespace)::mea_bf16_kernel<64, 64, 4, true>(unsigned short const*, "
     "unsigned short const*, unsigned short const*, float const*, unsigned short*, int, int, "
     "int, int, float, int)", "window"),
    ("void at::native::elementwise_kernel<128, 4>(int, float)", None)])
def test_roofline_reader_reads_the_full_mode_kernels(name, mode):
    from portbench.kernel_share import mea_mode

    assert mea_mode(name) == mode
