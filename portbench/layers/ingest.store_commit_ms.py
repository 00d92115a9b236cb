"""Host time of the store upsert's commit (``store.py``
``DocumentStore.upsert_batch``), from the program's "store.commit"
spans, per ``add_documents`` call, in ms."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.ms_per_unit(run, "store.commit")
