"""Operations and bytes of the work the benchmark counts, one file per
kernel or model: computed from shapes and token counts, never from the
program's own arithmetic.  Peaks are in ``portbench.common.SPECS``."""
