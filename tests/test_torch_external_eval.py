"""The port's external eval against the JAX package's, on the CPU.

The scorer is host numpy in both packages (normalisation floor 1e-9,
cosine top-k with ``argpartition``'s tie-break), so the same embeddings
must give the same recall exactly: checked on crafted encoders (an
oracle, a constant one, crafted ties, the feature-hash baseline).  The
bundled encoder's recall, dense half and shipped hybrid, is computed by
each package's own forward: the two may differ by at most one pair
(1/304) where a near-tie flips between the two frameworks' roundings.
On the CPU the two have agreed exactly: dense 38/304 (0.125), hybrid
102/304 (0.3355), legacy96 67/96.

JAX is imported inside the tests, so the ``cuda`` case also runs where
it is not installed:

    python -m pytest tests/test_torch_external_eval.py -m cuda -q --noconftest
"""

import numpy as np
import pytest
import torch

from modular_rag_system_tpu_torch.models import external_eval as pe


def _jax_eval():
    from modular_rag_system_tpu.models import external_eval as je

    return je


class _Oracle:
    """Gold pairs encode to matching one-hot rows: recall 1."""

    def __init__(self):
        q, p = pe.load_external_qa()
        self._order = {t: i for i, t in enumerate(q)}
        self._order.update({t: i for i, t in enumerate(p)})
        self.n = len(q)

    def encode(self, texts):
        out = np.zeros((len(texts), self.n), np.float32)
        for r, t in enumerate(texts):
            out[r, self._order[t]] = 1.0
        return out


class _Constant:
    def encode(self, texts):
        return np.ones((len(texts), 16), np.float32)


class _Ties:
    """Rows from a small seeded set of unit vectors: every query ties
    with many passages (exact ties broken by ``argpartition``); a few
    zero rows test the 1e-9 normalisation floor."""

    def __init__(self, groups=7, seed=0):
        rng = np.random.default_rng(seed)
        self.rows = rng.standard_normal((groups, 8)).astype(np.float32)
        self.groups = groups

    def encode(self, texts):
        out = self.rows[[sum(map(ord, t)) % self.groups for t in texts]]
        out[[i for i, t in enumerate(texts) if len(t) % 17 == 0]] = 0.0
        return out


def test_load_external_qa_equals_jax():
    q, p = pe.load_external_qa()
    assert (q, p) == _jax_eval().load_external_qa()
    assert len(q) == len(p) == 304 and len(set(p)) == 304


@pytest.mark.parametrize("p,n", [(0.5, 304), (0.0, 304), (1.0, 10), (0.3355, 304),
                                 (0.125, 304), (0.7, 96), (0.0, 0), (0.2, 1)])
def test_wilson_interval_equals_jax(p, n):
    lo, hi = pe.wilson_interval(p, n)
    assert (lo, hi) == _jax_eval().wilson_interval(p, n)
    assert 0.0 <= lo <= hi <= 1.0
    if n:
        assert lo <= p <= hi


def test_wilson_interval_values():
    lo, hi = pe.wilson_interval(0.5, 304)
    assert 0.44 < lo < 0.5 < hi < 0.56
    assert pe.wilson_interval(0.0, 0) == (0.0, 1.0)
    lo1, hi1 = pe.wilson_interval(1.0, 10)
    assert hi1 == 1.0 and lo1 > 0.6


@pytest.mark.parametrize("make,k", [(_Oracle, 1), (_Oracle, 10), (_Constant, 10),
                                    (_Ties, 10), (_Ties, 1), (_Ties, 400)],
                         ids=["oracle-1", "oracle-10", "constant", "ties-10", "ties-1",
                              "ties-k-past-pool"])
def test_crafted_encoders_equal_jax(make, k):
    je = _jax_eval()
    enc = make()
    r = pe.recall_at_k_external(enc, k=k)
    assert r == je.recall_at_k_external(enc, k=k)
    assert pe.recall_at_k_legacy96(enc, k=k) == je.recall_at_k_legacy96(enc, k=k)
    if make is _Oracle:
        assert r == 1.0
    if make is _Constant:
        assert r <= 0.3
    if k >= 304:
        assert r == 1.0


def test_hash_baseline_equals_jax_near_chance():
    from modular_rag_system_tpu.models.fake import FeatureHashEncoder as JaxHash
    from modular_rag_system_tpu_torch.models.fake import FeatureHashEncoder

    r = pe.recall_at_k_external(FeatureHashEncoder(dim=384), k=10)
    assert r == _jax_eval().recall_at_k_external(JaxHash(dim=384), k=10)
    assert r < 10 / 304 * 2.5


def test_bundled_dense_recall_equals_jax():
    r = pe.bundled_encoder_external_recall(k=10, device="cpu")
    rj = _jax_eval().bundled_encoder_external_recall(k=10)
    assert abs(r - rj) <= 1 / 304 + 1e-12, (r, rj)
    assert r > 10 / 304  # better than chance


def test_shipped_hybrid_recall_equals_jax():
    from modular_rag_system_tpu.config import RAGConfig as JaxConfig
    from modular_rag_system_tpu.models import build_encoder as jax_build_encoder
    from modular_rag_system_tpu_torch.config import RAGConfig
    from modular_rag_system_tpu_torch.models import build_encoder

    je = _jax_eval()
    enc, jenc = build_encoder(RAGConfig(), device="cpu"), jax_build_encoder(JaxConfig())
    assert enc.name == jenc.name
    r, rj = pe.recall_at_k_external(enc), je.recall_at_k_external(jenc)
    assert abs(r - rj) <= 1 / 304 + 1e-12, (r, rj)
    assert abs(pe.recall_at_k_legacy96(enc) - je.recall_at_k_legacy96(jenc)) <= 1 / 96 + 1e-12


@pytest.mark.cuda
def test_bundled_recall_on_the_card_equals_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    r_gpu = pe.bundled_encoder_external_recall(k=10, device="cuda")
    r_cpu = pe.bundled_encoder_external_recall(k=10, device="cpu")
    assert abs(r_gpu - r_cpu) <= 1 / 304 + 1e-12, (r_gpu, r_cpu)
