"""The share of the ingest cell's traced window in which no operation ran
on the device, in percent (the union of the profiler's device records)."""

from portbench.hooks import idle_share


def install(run, rec):
    pass


def read(run, rec, trace):
    return idle_share(trace)
