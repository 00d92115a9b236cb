"""Time in Python's garbage collector, from the program's "gc" spans
(every collection, any generation, while the tracer is on), per step,
in ms."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.ms_per_unit(run, "gc")
