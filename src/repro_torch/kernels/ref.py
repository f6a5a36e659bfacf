"""Dense plain-torch oracles for the port's kernels (port of
``repro.kernels.ref``)."""
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


def rglru_scan_ref(a, b):
    """h_t = a_t * h_{t-1} + b_t, h_{-1} = 0.  a, b: [B, S, W] float32.

    torch has no associative scan: this is the log-depth (Hillis-Steele)
    inclusive scan of the same operator, (a1, b1) . (a2, b2) =
    (a1 a2, a2 b1 + b2).  Its sum order differs from
    ``lax.associative_scan``'s, so the two agree to f32 rounding."""
    S = a.shape[1]
    d = 1
    while d < S:
        a_new, b_new = a.clone(), b.clone()
        b_new[:, d:] = a[:, d:] * b[:, :-d] + b[:, d:]
        a_new[:, d:] = a[:, d:] * a[:, :-d]
        a, b = a_new, b_new
        d *= 2
    return b


def rwkv6_scan_ref(r, k, v, w, u, s0=None):
    """RWKV-6 wkv recurrence, one token at a time.

    r,k,v,w: [B, S, H, hd] float32; u: [H, hd]; s0: [B, H, hd, hd] (zeros
    when None).
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T);  S_t = diag(w_t) S_{t-1} + k_t v_t^T
    Returns (out [B,S,H,hd], s_last [B,H,hd,hd]).
    """
    B, S, H, hd = r.shape
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0)
    outs = []
    for t in range(S):
        at = k[:, t, :, :, None] * v[:, t, :, None, :]      # [B, H, hd, hd]
        outs.append(torch.einsum("bhk,bhkv->bhv", r[:, t],
                                 s + u[None, :, :, None] * at))
        s = w[:, t, :, :, None] * s + at
    return torch.stack(outs, dim=1), s
