"""Child ranks of the port's multi-process tests (``test_torch_multihost.py``,
``test_torch_train_mesh.py``).  Each process is one rank of a gloo group
on the CPU (``parallel/mh_check.spawn_ranks`` starts them and appends
``RANK N HOST:PORT``); it writes what it saw to a file that the test
reads.  No JAX here: the tests hold these files against the JAX package.

    python -m tests.torch_mh_child engine OUT_DIR RANK N HOST:PORT
    python -m tests.torch_mh_child train DATA MODEL OUT_DIR RANK N HOST:PORT
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch

from modular_rag_system_tpu_torch import RAGConfig, create_engine
from modular_rag_system_tpu_torch.models.default_ckpt import params_from_flax, params_to_flax
from modular_rag_system_tpu_torch.models.encoder import MiniLMEncoder
from modular_rag_system_tpu_torch.types import Document

_TRAIN = Path(__file__).resolve().parents[1] / "modular_rag_system_tpu" / "assets" / "train"
KNOWLEDGE = json.loads((_TRAIN / "knowledge.json").read_text())["sentences"]
CORPUS = [(t, ["animals", "tech", "finance"][i % 3]) for i, t in enumerate(KNOWLEDGE[:120])]
QUESTIONS = ["programming language machine learning", "household pets", "stock market",
             *[it["query"] for it in json.loads((_TRAIN / "qa_pairs.json").read_text())
               ["items"][:3]]]
# the deep filtered refill: 1,200 filler rows and 3 rare ones, 300 results
FILLER = KNOWLEDGE[120:1320]
TIERS = ("exact", "fused", "bf16", "int8")

# the trainer cases: test_torch_train.py's tiny encoder and bars
PAIRS = [
    ("what is jax", "jax is a numerical computing library"),
    ("tpu hardware", "tensor processing units accelerate matmuls"),
    ("python dataclass", "dataclasses generate init and repr"),
    ("sqlite storage", "sqlite is an embedded relational database"),
    ("http server", "servers respond to get and post requests"),
    ("text chunking", "documents are split into token windows"),
    ("cosine similarity", "normalized dot product measures similarity"),
]
QS = [q for q, _ in PAIRS]
PS = [p for _, p in PAIRS]
ARCH = dict(dim=64, max_seq_len=32, batch_size=16, num_layers=2, num_heads=4,
            mlp_dim=128, vocab_size=1000)
LR, CLIP, WARMUP, STEPS = 1e-3, 0.05, 2, 3


def fake_overrides(path, **extra):
    return {"embedding.model": "fake", "embedding.dim": 384, "store.storage_path": str(path),
            "retrieval.similarity_threshold": 0.0, "retrieval.time_weight": 0.0, **extra}


def bf16_encoder(eng):
    """Round the engine's embeddings to bf16-representable values, so the
    fused and bf16 tiers (bf16 products in the port, true f32 products in
    JAX's interpret mode) see the same products in both packages."""
    enc = eng.encoder

    def rounded(fn):
        return lambda texts: torch.from_numpy(np.asarray(fn(texts), np.float32)).to(
            torch.bfloat16).float().numpy()

    enc.encode, enc.encode_queries = rounded(enc.encode), rounded(enc.encode_queries)
    return eng


def fields(results):
    return [{"ids": [d.id for d in r.documents], "similarities": list(r.similarities),
             "total_documents_searched": r.total_documents_searched} for r in results]


def drive_engine(eng, Doc, deep):
    """The queries every engine case answers: top 5, a source filter and,
    with ``deep``, the filtered refill through the deep route."""
    eng.add_documents([Doc(content=t, source=src) for t, src in CORPUS])
    out = {"top5": fields(eng.query_batch(QUESTIONS, max_results=5)),
           "filtered": fields(eng.query_batch(QUESTIONS, max_results=3,
                                              source_filters=["finance"]))}
    if deep:
        eng.add_documents([Doc(content=t, source="filler") for t in FILLER])
        eng.add_documents([Doc(content=f"rare note {i}", source="rare") for i in range(3)])
        out["deep"] = fields(eng.query_batch(QUESTIONS, max_results=300,
                                             source_filters=["rare"]))
    return out


def engine_case(out_dir, rank, n, coord):
    import torch.distributed as dist

    from modular_rag_system_tpu_torch.index import DeviceIndex
    from modular_rag_system_tpu_torch.parallel.sharded import ShardedIndex

    report = {"tiers": {}}
    for tier in TIERS:
        cfg = RAGConfig.load(overrides=fake_overrides(
            Path(out_dir) / tier / f"rank{rank}", **{
                "index.tier": tier, "mesh.multihost": True, "mesh.coordinator": coord,
                "mesh.num_processes": n, "mesh.process_id": rank}))
        eng = bf16_encoder(create_engine(cfg, device="cpu", index_devices=["cpu", "cpu"]))
        idx = eng.index
        assert isinstance(idx, ShardedIndex) and idx.group is not None
        report["layout"] = [cfg.mesh.index_shards, cfg.mesh.dcn_slices, idx.S, idx._s0,
                            len(idx.devices)]
        report["tiers"][tier] = drive_engine(eng, Document, deep=tier == "exact")
        report["tiers"][tier]["count"] = idx.count
        report["tiers"][tier]["effective_tier"] = idx.effective_tier()
        if tier == "exact":
            # what needs every row on one host raises, as in JAX
            errors = {}
            one = Path(out_dir) / f"one{rank}.npz"  # a one-process snapshot
            DeviceIndex(dim=8, device="cpu").snapshot(str(one))
            for what, fn in (("build_ann", idx.build_ann),
                             ("snapshot", lambda: idx.snapshot(str(Path(out_dir) / "x.npz"))),
                             ("load", lambda: ShardedIndex.load(
                                 str(one), mesh=["cpu", "cpu"], device="cpu",
                                 group=dist.group.WORLD)),
                             ("shutdown", eng.shutdown)):
                try:
                    fn()
                    errors[what] = None
                except RuntimeError as e:
                    errors[what] = str(e)
            report["errors"] = errors
            eng.store.close()
        else:
            eng.config.store.snapshot_on_shutdown = False
            eng.shutdown()
    (Path(out_dir) / f"rank{rank}.json").write_text(json.dumps(report))


def seeded_flat(seed=0):
    """test_torch_train.py's weights: the port's random init at a seed
    plus numpy-seeded noise, as flat flax params."""
    enc = MiniLMEncoder(**ARCH, dtype="float32", device="cpu", seed=seed)
    flat = params_to_flax(enc.params, ARCH["num_heads"])
    rng = np.random.default_rng(seed)
    return {k: (v + rng.normal(0.0, 0.02, v.shape)).astype(np.float32)
            for k, v in flat.items()}


def train_case(data, model, out_dir, rank, n, coord):
    from modular_rag_system_tpu_torch.models.train import ContrastiveTrainer
    from modular_rag_system_tpu_torch.parallel import multihost
    from modular_rag_system_tpu_torch.parallel.mesh import make_train_mesh

    multihost.initialize_multihost(coord, n, rank)
    mesh = make_train_mesh(data, model)
    enc = MiniLMEncoder(**ARCH, dtype="float32", device="cpu",
                        state_dict=params_from_flax(seeded_flat()))
    trainer = ContrastiveTrainer(enc, mesh, learning_rate=LR, clip_norm=CLIP,
                                 warmup_steps=WARMUP)
    steps = [trainer.step(QS, PS) for _ in range(STEPS)]
    report = {"steps": steps, "cell": (mesh.data_index, mesh.model_index),
              "params": {k: p.detach().clone() for k, p in trainer.params.items()}}
    ckpt = Path(out_dir) / "ckpt.pt"
    trainer.save_checkpoint(str(ckpt))
    trainer.sync_encoder()
    report["published"] = {k: v.clone() for k, v in enc.params.items()}
    report["next_step"] = trainer.step(QS, PS)
    torch.save(report, Path(out_dir) / f"rank{rank}.pt")


def main(argv):
    torch.set_num_threads(1)
    mode, rest = argv[0], argv[1:]
    rank, n, coord = int(rest[-3]), int(rest[-2]), rest[-1]
    if mode == "engine":
        engine_case(rest[0], rank, n, coord)
    else:
        train_case(int(rest[0]), int(rest[1]), rest[2], rank, n, coord)


if __name__ == "__main__":
    main(sys.argv[1:])
