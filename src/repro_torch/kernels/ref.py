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

    On the meta device (a dry run, which computes nothing) the loop's body
    runs once and is counted S times (:class:`_MetaScan`), as the JAX
    package's cost parser counts a ``lax.scan`` body by its trip count.
    """
    B, S, H, hd = r.shape
    s = (torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
         if s0 is None else s0)
    if r.is_meta and S > 1:
        return _MetaScan.apply(r, k, v, w, u, s)
    return _token_loop(r, k, v, w, u, s)


def _token_loop(r, k, v, w, u, s):
    """:func:`rwkv6_scan_ref`'s loop over the tokens from state ``s``."""
    outs = []
    for t in range(r.shape[1]):
        out, s = _wkv_step(r[:, t], k[:, t], v[:, t], w[:, t], u, s)
        outs.append(out)
    return torch.stack(outs, dim=1), s


def _wkv_step(rt, kt, vt, wt, u, s):
    """One token of :func:`rwkv6_scan_ref`: (out_t, S_t) from S_{t-1}."""
    at = kt[:, :, :, None] * vt[:, :, None, :]              # [B, H, hd, hd]
    out = torch.einsum("bhk,bhkv->bhv", rt, s + u[None, :, :, None] * at)
    return out, wt[:, :, :, None] * s + at


class _MetaScan(torch.autograd.Function):
    """The token loop on the meta device: one step, counted S times.

    Meta tensors carry no values, so every step of the loop is the same
    work on the same shapes.  The forward runs step 0 under
    ``hlo_static.trip_count(S)`` (its FLOPs and bytes scaled by S) and
    stacks S copies of its output, as the loop stacks its S outputs; the
    backward runs the step's backward once, scaled the same way.  The
    counted FLOPs are the loop's, forward and backward, and so are the
    forward's bytes; the backward's bytes are the steps' own (the loop's
    autograd also writes a whole-sequence zero gradient per step's slice,
    which is not counted).  For the memory tracker, a buffer of the three
    state-sized tensors per step that the loop's autograd keeps is saved
    for the backward when an input needs a gradient (as a saved tensor,
    so that activation checkpointing drops it as it drops the loop's)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s):
        from repro_torch.launch.hlo_static import trip_count
        S = r.shape[1]
        with trip_count(S):
            out, s_last = _wkv_step(r[:, 0], k[:, 0], v[:, 0], w[:, 0], u, s)
        kept = (torch.empty((3 * S,) + tuple(s.shape), device="meta")
                if any(ctx.needs_input_grad) else None)
        ctx.save_for_backward(r, k, v, w, u, s, kept)
        return torch.stack([out] * S, dim=1), s_last

    @staticmethod
    def backward(ctx, g_out, g_s):
        from repro_torch.launch.hlo_static import trip_count
        full = ctx.saved_tensors[:6]
        S = full[0].shape[1]
        step = [t[:, 0] if i < 4 else t for i, t in enumerate(full)]
        step = [t.detach().requires_grad_(need)
                for t, need in zip(step, ctx.needs_input_grad)]
        with torch.enable_grad():
            with trip_count(0):
                out, s_last = _wkv_step(*step)
            wanted = [t for t in step if t.requires_grad]
            with trip_count(S):
                grads = iter(torch.autograd.grad(
                    (out, s_last), wanted, (g_out[:, 0], g_s),
                    allow_unused=True))
        return tuple(
            (torch.empty_like(t) if i < 4 else next(grads)) if need else None
            for i, (t, need) in enumerate(zip(full, ctx.needs_input_grad)))
