"""Layer: the device, the whole step of a latent-attention model.  The
model's FLOPs over the window's steps (``counts_mla.model_flops``: the
products of the parameters each token uses, MLA's projections as they
are, and the causal attention at its q/k and v head dims) over the
window's time at the card's bf16 peak (%, host clock).  Nothing to read
for a model without latent attention."""
from chipbench import counts, counts_mla


def read(run):
    m = run.cell.conf["model"]
    if "kv_lora_rank" not in m:
        return None
    t = run.cell.traffic
    flops = counts_mla.model_flops(m, t["batch"], t["seq"])
    return 100.0 * flops * run.steps \
        / (run.window_s * counts.PEAK_FLOPS)
