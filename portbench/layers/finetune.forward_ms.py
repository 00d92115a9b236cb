"""Host time of the trainer's forward (``models/train.py``: the module
forward of the queries and of the positives, then the logits and the
loss), from the program's "trainer.forward" spans, per step, in ms.  The
spans do not synchronize: this is the host's time to launch the work,
plus any wait the device imposes on it."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.ms_per_unit(run, "trainer.forward")
