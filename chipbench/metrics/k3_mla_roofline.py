"""Layer: the kernels, K3 at latent attention's head dims
(``csrc/flash_attention.cu``, q and k at qk_nope + qk_rope, v and o at
v_head_dim).  Over the traced steps: each K3 launch's least time on the
card, max(FLOPs / peak, bytes / bandwidth), from the live causal (q, k)
pairs at 2 (dqk + dv) FLOPs a pair a head and the q, k, v and o bytes at
the cell's shape (``chipbench/counts_mla.py``), summed and divided by K3's
device time (%).  Nothing to read where K3 does not run or the model has
no latent attention."""
from chipbench import counts, counts_mla

K3 = r"flash_attention"


def read(run):
    cfg = run.cfg
    if run.trace is None or not getattr(cfg, "v_head_dim", 0):
        return None
    n, seconds = run.trace.ops_matching(K3)
    if n == 0 or seconds <= 0:
        return None
    t = run.cell.traffic
    B, S = t["batch"], t["seq"]
    dqk = cfg.qk_nope_head_dim + cfg.qk_rope_head_dim
    least = counts.roofline_s(
        counts_mla.attention_flops(B, S, cfg.n_heads, dqk, cfg.v_head_dim),
        counts_mla.attention_bytes(B, S, cfg.n_heads, dqk, cfg.v_head_dim,
                                   2))
    return 100.0 * n * least / seconds
