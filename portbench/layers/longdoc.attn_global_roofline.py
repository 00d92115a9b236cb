"""``mea_attention``'s share of its roofline in the global layers' full
mode, in percent: the least time the card could take for the query-key
pairs and the rows that the program's counters
``encoder.attn_global_pairs`` and ``encoder.attn_global_rows`` count
over the profiled units at the launched shapes, padding included
(``roofline/mea_attention``), over the device
time of the full mode's kernel in the profile."""

from portbench import kernel_share
from portbench.roofline.mea_attention import bound_s


def install(run, rec):
    kernel_share.install(run, rec)


def read(run, rec, trace):
    c = kernel_share.counters(run)
    t = kernel_share.device_seconds(trace, lambda n: kernel_share.mea_mode(n) == "full")
    if not c or not c.get("encoder.attn_global_pairs") or t is None or run.spec is None:
        return None
    hf = run.config["hf_config"]
    dh = hf["hidden_size"] // hf["num_attention_heads"]
    bound = bound_s(c["encoder.attn_global_pairs"], c["encoder.attn_global_rows"], dh, run.spec)
    return 100.0 * bound / t
