"""Layer: the device, the whole step.  The model's FLOPs over the window's
steps (``counts.model_flops``: the products of the parameters each token
uses, and the causal attention scores or the wkv recurrence) over the
window's time at the card's bf16 peak (%, host clock).  Proportional to
``prefill_tok_s``, so it bounds any gain once a kernel leaves the path."""
from chipbench import counts


def read(run):
    t = run.cell.traffic
    flops = counts.model_flops(run.cell.conf["model"], t["batch"], t["seq"])
    return 100.0 * flops * run.steps / (run.window_s * counts.PEAK_FLOPS)
