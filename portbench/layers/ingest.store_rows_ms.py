"""Host time of the store upsert's Python rows (``store.py``
``DocumentStore.upsert_batch``: the loop that builds the update and
insert tuples), from the program's "store.rows" spans, per
``add_documents`` call, in ms."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.ms_per_unit(run, "store.rows")
