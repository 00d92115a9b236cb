"""Time of the index append (``index.py`` ``DeviceIndex.add``,
synchronized) per ``add_documents`` call, in ms."""

from portbench.hooks import span_ms_per_unit


def install(run, rec):
    rec.hook(run.engine.index, "add", span="index_add", sync=True)


def read(run, rec, trace):
    return span_ms_per_unit(run, rec, "index_add")
