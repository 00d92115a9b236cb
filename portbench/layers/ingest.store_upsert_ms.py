"""Host time of the document store's upsert (``store.py``
``DocumentStore.upsert_batch``) per ``add_documents`` call, in ms."""

from portbench.hooks import span_ms_per_unit


def install(run, rec):
    rec.hook(run.engine.store, "upsert_batch", span="store_upsert")


def read(run, rec, trace):
    return span_ms_per_unit(run, rec, "store_upsert")
