"""Dense plain-torch oracle for the attention kernel (port of
``repro.kernels.ref.attention_ref``)."""
from __future__ import annotations

import torch


def attention_ref(q, k, v, *, causal: bool = True, window: int = 0,
                  kv_len: int | None = None):
    """q: [B, Sq, H, hd]; k, v: [B, Sk, K, hd] (GQA: H % K == 0).

    window <= 0 means unlimited; kv_len masks trailing kv padding.
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, Sq, K, G, hd).float()
    logits = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) * (hd ** -0.5)
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qi >= kj
    if window and window > 0:
        mask &= qi - kj < window
    if kv_len is not None:
        mask &= kj < kv_len
    logits = torch.where(mask, logits, torch.tensor(-1e30, device=q.device))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskh->bqkgh", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)
