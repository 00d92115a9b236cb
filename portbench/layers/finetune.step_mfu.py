"""The training window's share of the card's peak, in percent: each
step's matmul FLOPs over the real tokens of its queries and positives
(``roofline/train_step``) at the bf16 peak, over the traced window's
wall time."""

from portbench.hooks import mfu


def install(run, rec):
    pass


def read(run, rec, trace):
    flops = run.state.get("flops")
    if not flops:
        return None
    rec.work["bf16"] = flops
    return mfu(run, rec, trace)
