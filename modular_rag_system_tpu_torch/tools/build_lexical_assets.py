"""Build the lexical encoder's statistics: the IDF table and the PMI
co-occurrence ``ExpansionTable``, through the one recipe in
``models.lexical.build_lexical_statistics`` (shared with
``build_default_encoder`` so the assets cannot drift).

Pure host work, a couple of minutes; no device.  Run after any change to
the stemmer, lexicon or corpora so the statistics stay consistent with
the feature definition (``models/lexical.py``):

    python -m modular_rag_system_tpu_torch.tools.build_lexical_assets --out DIR

Prints one JSON line with table sizes and the held-out QA recall of the
lexical encoder on the new statistics (the tuning signal; the external
eval is never consulted).
"""

from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

import numpy as np


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True,
                    help="directory for idf.json and expansion.json")
    args = ap.parse_args(argv)

    from modular_rag_system_tpu_torch.models.corpus import load_train_qa
    from modular_rag_system_tpu_torch.models.lexical import (
        ExpansionTable,
        IdfTable,
        LexicalHashEncoder,
        build_lexical_statistics,
    )

    stats = build_lexical_statistics(args.out)
    print(f"[lex-assets] {stats}", file=sys.stderr)

    # held-out split mirrors build_default_encoder exactly
    qa_q, qa_p = load_train_qa()
    order = list(range(len(qa_q)))
    random.Random(13).shuffle(order)
    ho_q = [qa_q[i] for i in order][-96:]
    ho_p = [qa_p[i] for i in order][-96:]

    d = Path(stats["asset_dir"])
    lex = LexicalHashEncoder(
        dim=384,
        idf=IdfTable.load(str(d / "idf.json")),
        expansion=ExpansionTable.load(str(d / "expansion.json")),
    )
    s = lex.encode(ho_q) @ lex.encode(ho_p).T
    top = np.argsort(-s, axis=1)[:, :10]
    recall = float(np.mean([i in top[i] for i in range(len(ho_q))]))

    print(json.dumps({
        **{k: v for k, v in stats.items() if k != "corpora"},
        "heldout_qa_recall@10/lexical": round(recall, 4),
    }))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
