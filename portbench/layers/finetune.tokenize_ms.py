"""Host time of the trainer's tokenizing (``models/train.py``
``ContrastiveTrainer._tokenize``: ``encode_batch`` of the queries and of
the positives, and their copy to the device), from the program's
"trainer.tokenize" spans, per step, in ms."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.ms_per_unit(run, "trainer.tokenize")
