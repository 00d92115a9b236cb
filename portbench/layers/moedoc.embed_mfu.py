"""The mixture-of-experts ingest window's share of the card's peak, in
percent: the DeepSeek-V3 forward's FLOPs over the real tokens of every
document (``roofline/deepseek_v3``: 2 per active weight and token, 2
(d_qk + d_v) per head and live causal pair and layer) at the bf16 peak,
over the traced window's wall time."""

from portbench.hooks import dense_of, mfu
from portbench.roofline.deepseek_v3 import forward_flops


def install(run, rec):
    cfg = run.config["hf_config"]

    def on_call(rec, args, kwargs, out):
        mask = args[1] if len(args) > 1 else kwargs["mask"]
        rec.add("work", "bf16", forward_flops(cfg, (int(n) for n in mask.sum(axis=1))))

    rec.hook(dense_of(run.engine), "forward_tokens", span="forward", sync=True, on_call=on_call)


def read(run, rec, trace):
    return mfu(run, rec, trace)
