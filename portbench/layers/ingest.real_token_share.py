"""The share of the positions the encoder's forward runs that hold a
real token (``models/encoder.py`` ``encode_device``, after the crop to
the longest text's bucket and the pad to a power-of-two batch), from the
program's counters "encoder.real_tokens" and "encoder.padded_tokens",
in percent."""

from portbench import program_spans


def install(run, rec):
    program_spans.install(run, rec)


def read(run, rec, trace):
    return program_spans.share(run, "encoder.real_tokens", "encoder.padded_tokens")
