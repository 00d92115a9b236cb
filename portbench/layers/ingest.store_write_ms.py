"""Host time of the store upsert's writes (``store.py``
``DocumentStore.upsert_batch``: the ``executemany`` of the updates and
of the inserts), from the program's "store.write" spans, per
``add_documents`` call, in ms."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.ms_per_unit(run, "store.write")
