"""Time of the trainer's update (``models/train.py``
``ContrastiveTrainer._update``: global-norm clip and AdamW over every
weight, synchronized) per step, in ms."""

from portbench.hooks import span_ms_per_unit


def install(run, rec):
    rec.hook(run.trainer, "_update", span="update", sync=True)


def read(run, rec, trace):
    return span_ms_per_unit(run, rec, "update")
