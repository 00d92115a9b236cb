"""The ingest window's share of the card's peak, in percent: the
encoder forward's FLOPs over the real tokens of every document at the
bf16 peak, over the traced window's wall time."""

from portbench.hooks import count_forward, mfu


def install(run, rec):
    count_forward(run, rec, run.engine)


def read(run, rec, trace):
    return mfu(run, rec, trace)
