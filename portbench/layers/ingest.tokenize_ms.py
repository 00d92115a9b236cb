"""Host time of the tokenizer (``models/tokenizer.py``
``WordPieceTokenizer.encode_batch``, native engine or Python) per
``add_documents`` call, in ms."""

from portbench.hooks import dense_of, span_ms_per_unit


def install(run, rec):
    rec.hook(dense_of(run.engine).tokenizer, "encode_batch", span="tokenize")


def read(run, rec, trace):
    return span_ms_per_unit(run, rec, "tokenize")
