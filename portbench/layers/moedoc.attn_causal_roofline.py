"""``mea_attention``'s share of its roofline in its causal mode, in
percent: the least time the card could take for the live causal pairs
and rows that the program's counters ``encoder.attn_causal_pairs`` and
``encoder.attn_causal_rows`` count over the profiled units
(``roofline/mea_causal``), over the device time of the causal mode's
kernel in the profile (``mea_causal_kernel``, by its name)."""

from portbench import kernel_share
from portbench.roofline.mea_causal import bound_s


def is_causal(name: str) -> bool:
    return "mea_causal_kernel" in name


def install(run, rec):
    kernel_share.install(run, rec)


def read(run, rec, trace):
    c = kernel_share.counters(run)
    t = kernel_share.device_seconds(trace, is_causal)
    if not c or not c.get("encoder.attn_causal_pairs") or t is None or run.spec is None:
        return None
    hf = run.config["hf_config"]
    dqk = hf["qk_nope_head_dim"] + hf["qk_rope_head_dim"]
    bound = bound_s(c["encoder.attn_causal_pairs"], c["encoder.attn_causal_rows"], dqk,
                    hf["v_head_dim"], run.spec)
    return 100.0 * bound / t
