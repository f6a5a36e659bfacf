"""Layer: the kernels, K5 (``csrc/rwkv6_scan.cu`` through
``kernels/ops.py``).  Over the traced steps: each K5 launch's byte bound
(f32 r, k, v, w and u read once, out and the last state written once) at
the card's bandwidth, summed and divided by K5's device time (%).
Nothing to read where K5 does not run."""
from chipbench import counts

K5 = r"rwkv6_scan"


def read(run):
    if run.trace is None:
        return None
    n, seconds = run.trace.ops_matching(K5)
    if n == 0 or seconds <= 0:
        return None
    cfg, t = run.cfg, run.cell.traffic
    hd = cfg.rwkv_head_dim
    least = counts.scan_bytes(t["batch"], t["seq"], cfg.d_model // hd, hd) \
        / counts.HBM_BW
    return 100.0 * n * least / seconds
