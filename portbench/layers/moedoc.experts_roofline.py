"""The expert layers' SwiGLU GEMMs' share of the card's bf16 peak, in
percent: their operations over the profiled units, 2 x rows x hidden x 3
x width for each kind of grouped call (the routed pairs at
``moe_intermediate_size``, the shared experts' rows at
``n_shared_experts`` x that, the dense layers' rows at
``intermediate_size``: the program's counters ``encoder.moe_pairs``,
``encoder.moe_rows`` and ``encoder.moe_grouped_rows``, the last their
sum), at the bf16 peak, over the device time of the grouped kernels in the
profile (``moe_grouped_kernel``, by its name).  A tile's rows past its
group's end are computed but not counted, so the share cannot pass 100%.
A program without the grouped kernels, or without the counter, has
nothing to read."""

from portbench import kernel_share


def is_grouped(name: str) -> bool:
    return "moe_grouped_kernel" in name


def swiglu_flops(hf: dict, pairs: int, rows: int, grouped_rows: int) -> int:
    """The SwiGLU GEMMs' operations: ``pairs`` routed rows, ``rows`` rows of
    the shared experts, and the rest of ``grouped_rows`` dense rows."""
    h, m = hf["hidden_size"], hf["moe_intermediate_size"]
    dense = grouped_rows - pairs - rows
    return 2 * h * 3 * (pairs * m + rows * hf["n_shared_experts"] * m
                        + dense * hf["intermediate_size"])


def install(run, rec):
    kernel_share.install(run, rec)


def read(run, rec, trace):
    c = kernel_share.counters(run)
    t = kernel_share.device_seconds(trace, is_grouped)
    if not c or not c.get("encoder.moe_grouped_rows") or t is None or run.spec is None:
        return None
    flops = swiglu_flops(run.config["hf_config"], c.get("encoder.moe_pairs", 0),
                         c.get("encoder.moe_rows", 0), c["encoder.moe_grouped_rows"])
    return 100.0 * flops / run.spec["bf16"] / t
