"""Host time of the expert layers' routing (the program's span
``encoder.moe_route``: the f32 router, the top-k choice, the sort of the
(token, expert) pairs and the gather of their rows, and the weighted
combine, ``models/deepseek_v3.py``) per ``add_documents`` call, in ms.
The span does not synchronise the device: the read-back of the experts'
row counts, which waits for the work queued before it, is a span of its
own (``encoder.moe_counts``) that no metric reads."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.ms_per_unit(run, "encoder.moe_route")
