"""The share of the positions the trainer's forward runs that hold a
real token (``models/train.py``: texts are padded to ``max_len``), from
the program's counters "trainer.real_tokens" (the masks' sums) and
"trainer.padded_tokens" (their sizes), in percent."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.share(run, "trainer.real_tokens", "trainer.padded_tokens")
