"""Layer: the kernels, K3 (``csrc/flash_attention.cu`` through
``kernels/ops.py``).  Over the traced steps: each K3 launch's least time on
the card, max(FLOPs / peak, bytes / bandwidth), from the live causal
(q, k) pairs and the q, k, v and o bytes at the cell's shape, summed and
divided by K3's device time (%).  Nothing to read where K3 does not run."""
from chipbench import counts

K3 = r"flash_attention"


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.ops_matching(K3)
    if n == 0 or seconds <= 0:
        return None
    cfg, t = run.cfg, run.cell.traffic
    B, S = t["batch"], t["seq"]
    least = counts.roofline_s(
        counts.attention_flops(B, S, S, cfg.n_heads, cfg.hd, causal=True,
                               window=0),
        counts.attention_bytes(B, S, S, cfg.n_heads, cfg.n_kv_heads, cfg.hd,
                               2))
    return 100.0 * n * least / seconds
