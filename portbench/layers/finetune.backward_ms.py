"""Host time of the trainer's backward (``models/train.py``
``torch.autograd.grad`` of the loss), from the program's
"trainer.backward" spans, per step, in ms; unsynchronized, as the
forward's."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.ms_per_unit(run, "trainer.backward")
