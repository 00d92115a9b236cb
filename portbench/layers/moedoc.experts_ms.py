"""Host time of the expert layers' GEMMs (the program's span
``encoder.moe_experts``: each expert's SwiGLU over its rows and the
shared experts, ``models/deepseek_v3.py``) per ``add_documents`` call, in
ms.  The span does not synchronise the device: where the host runs ahead
of the card it measures issue time, and the wait lands in the next span
that reads a device value (``encoder.moe_counts``, the next layer's
expert counts)."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.ms_per_unit(run, "encoder.moe_experts")
