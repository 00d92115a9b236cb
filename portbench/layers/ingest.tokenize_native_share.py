"""The share of the rows that the tokenizer's ``encode_batch``
(``models/tokenizer.py``) sent to the native engine
(``native/text_engine.cpp``) rather than its Python path, from the
program's counters "tokenizer.native_rows" and "tokenizer.rows", in
percent.  A program without those counters reads nothing."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.share(run, "tokenizer.native_rows", "tokenizer.rows")
