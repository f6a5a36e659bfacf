"""Recurrent temporal-mix layers (port of ``repro.models.recurrent``): RG-LRU
(RecurrentGemma/Griffin) and RWKV-6 (Finch, data-dependent decay).  Both
have a parallel prefill path and a single-step decode path.

``use_kernel=True`` on a prefill sends the scan to the port's kernel
wrapper (``kernels.ops``), as the JAX layers send it to the Pallas kernel;
the model itself never sets it, as in the JAX package.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import rglru_scan_ref, rwkv6_scan_ref

from .base import ModelConfig, P

# ---------------------------------------------------------------------------
# RG-LRU (Griffin): h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)
# ---------------------------------------------------------------------------

_C_LOG_A = -8.0     # Griffin's  c * softplus(Lambda)  scaling


def rglru_struct(cfg: ModelConfig):
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    cw = cfg.conv_width
    return {
        "in_x": P((d, w), ("embed", "mlp")),
        "in_y": P((d, w), ("embed", "mlp")),
        "conv_w": P((cw, w), ("conv", "mlp"), scale=0.02),
        "conv_b": P((w,), ("mlp",), init="zeros"),
        "gate_a": P((w, w), ("mlp", "mlp2"), scale=0.02),
        "gate_i": P((w, w), ("mlp", "mlp2"), scale=0.02),
        "log_lambda": P((w,), ("mlp",), init="ones"),
        "out": P((w, d), ("mlp", "embed")),
    }


def _rglru_coeffs(params, xb):
    """Per-step recurrence coefficients a_t, b_t (f32) from branch input xb.
    The sigmoids run in xb's dtype, the rest in f32."""
    r = torch.sigmoid(xb @ params.gate_a.to(xb.dtype))
    i = torch.sigmoid(xb @ params.gate_i.to(xb.dtype))
    log_a = _C_LOG_A * F.softplus(params.log_lambda.float()) * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i.float() * xb.float())
    return a, b


def _conv1d(params, x, state=None):
    """Causal depthwise conv along time, taps summed in tap order.  x: [B,
    S, w]; state: the last cw-1 inputs (decode).  ``cat`` promotes x and
    the state to a common dtype, as ``jnp.concatenate`` does."""
    cw = params.conv_w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * params.conv_w[0].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * params.conv_w[i].to(x.dtype)
    new_state = xp[:, xp.shape[1] - (cw - 1):]
    return out + params.conv_b.to(x.dtype), new_state


def rglru(params, x, *, cfg: ModelConfig, state=None,
          use_kernel: bool = False):
    """x: [B, S, d].  state = dict(conv=[B,cw-1,w], h=[B,w]) for decode.

    Returns (out [B,S,d], new_state); the state's h is the last step
    rounded to x's dtype, then f32, as in the JAX package."""
    gx = F.gelu(x @ params.in_x.to(x.dtype), approximate="tanh")
    xb = x @ params.in_y.to(x.dtype)
    xb, conv_state = _conv1d(params, xb, None if state is None
                             else state["conv"])
    a, b = _rglru_coeffs(params, xb)

    if state is None:
        h = kops.rglru_scan(a, b) if use_kernel else rglru_scan_ref(a, b)
    else:
        h = a * state["h"][:, None, :] + b        # S == 1
    h = h.to(x.dtype)
    out = (gx * h) @ params.out.to(x.dtype)
    return out, {"conv": conv_state, "h": h[:, -1, :].float()}


def rglru_state_struct(cfg: ModelConfig, batch: int):
    w, cw = cfg.lru_width or cfg.d_model, cfg.conv_width
    return {"conv": P((batch, cw - 1, w), ("batch", None, "mlp"),
                      init="zeros"),
            "h": P((batch, w), ("batch", "mlp"), init="zeros",
                   dtype="float32")}


# ---------------------------------------------------------------------------
# RWKV-6 (Finch) time-mix + channel-mix
# ---------------------------------------------------------------------------

def rwkv6_struct(cfg: ModelConfig):
    d = cfg.d_model
    hd = cfg.rwkv_head_dim
    H = d // hd
    lora = max(32, d // 16)
    return {
        "tm": {   # time-mix interpolation deltas (data-dependent, Finch)
            "mu_base": P((5, d), (None, "embed"), init="zeros"),
            "lora_a": P((d, lora), ("embed", "mlp"), scale=0.02),
            "lora_b": P((5, lora, d), (None, "mlp", "embed"), scale=0.02),
            "wr": P((d, d), ("embed", "heads_x")),
            "wk": P((d, d), ("embed", "heads_x")),
            "wv": P((d, d), ("embed", "heads_x")),
            "wg": P((d, d), ("embed", "heads_x")),
            "wo": P((d, d), ("heads_x", "embed")),
            "decay_base": P((d,), ("embed",), init="zeros"),
            "decay_a": P((d, lora), ("embed", "mlp"), scale=0.02),
            "decay_b": P((lora, d), ("mlp", "embed"), scale=0.02),
            "bonus": P((H, hd), ("heads", "head_dim"), init="zeros"),
            "ln_x": P((d,), ("embed",), init="ones"),
        },
        "cm": {   # channel mix
            "mu_k": P((d,), ("embed",), init="zeros"),
            "wk": P((d, cfg.d_ff), ("embed", "mlp")),
            "wv": P((cfg.d_ff, d), ("mlp", "embed")),
            "mu_r": P((d,), ("embed",), init="zeros"),
            "wr": P((d, d), ("embed", "heads_x")),
        },
    }


def _token_shift(x, last):
    """shifted[t] = x[t-1]; position 0 takes `last` (decode state)."""
    if last is None:
        last = torch.zeros_like(x[:, :1])
    return torch.cat([last, x[:, :-1]], dim=1)


def rwkv6_time_mix(p, x, *, cfg: ModelConfig, state=None,
                   use_kernel: bool = False):
    """x: [B, S, d]. state = dict(shift=[B,1,d], wkv=[B,H,hd,hd])."""
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    xs = _token_shift(x, None if state is None else state["shift"])
    dx = xs - x
    # data-dependent interpolation (Finch lora)
    lx = torch.tanh(x @ p.lora_a.to(x.dtype))
    mu = p.mu_base.to(x.dtype)[:, None, None, :] \
        + torch.einsum("bsl,nld->nbsd", lx, p.lora_b.to(x.dtype))
    xr, xk, xv, xg, xw = [x + dx * mu[i] for i in range(5)]

    r = (xr @ p.wr.to(x.dtype)).reshape(B, S, H, hd)
    k = (xk @ p.wk.to(x.dtype)).reshape(B, S, H, hd)
    v = (xv @ p.wv.to(x.dtype)).reshape(B, S, H, hd)
    g = F.silu(xg @ p.wg.to(x.dtype))
    # data-dependent decay  w_t in (0, 1)
    dw = torch.tanh(xw @ p.decay_a.to(x.dtype)) @ p.decay_b.to(x.dtype)
    logw = -torch.exp(torch.clamp(p.decay_base.float() + dw.float(),
                                  -8.0, 4.0))
    w = torch.exp(logw).reshape(B, S, H, hd)               # decay per channel
    u = p.bonus.float()                                    # [H, hd]

    rf, kf, vf = (t.float() for t in (r, k, v))

    if state is None and use_kernel:
        out, s_last = kops.rwkv6_scan(rf, kf, vf, w, u)
    elif (state is None and cfg.rwkv_impl == "chunked"
          and (ch := rwkv6_wkv_chunked(
              rf, kf, vf, logw.reshape(B, S, H, hd), u,
              chunk=cfg.rwkv_chunk)) is not None):
        out, s_last = ch
    else:
        out, s_last = rwkv6_scan_ref(rf, kf, vf, w, u,
                                     s0=None if state is None
                                     else state["wkv"])

    out = out.to(x.dtype)
    # group norm over heads (ln_x; population variance), then gate
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = ((out - mean) * torch.rsqrt(var + 64e-5)).reshape(B, S, d)
    out = out * p.ln_x.to(x.dtype)
    out = (out * g) @ p.wo.to(x.dtype)
    return out, {"shift": x[:, -1:, :], "wkv": s_last}


def rwkv6_channel_mix(p, x, *, state=None):
    xs = _token_shift(x, None if state is None else state["shift"])
    dx = xs - x
    xk = x + dx * p.mu_k.to(x.dtype)
    xr = x + dx * p.mu_r.to(x.dtype)
    k = torch.square(torch.relu(xk @ p.wk.to(x.dtype)))
    r = torch.sigmoid(xr @ p.wr.to(x.dtype))
    out = r * (k @ p.wv.to(x.dtype))
    return out, {"shift": x[:, -1:, :]}


def rwkv6_state_struct(cfg: ModelConfig, batch: int):
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    H = d // hd
    return {
        "tm_shift": P((batch, 1, d), ("batch", None, "embed"), init="zeros"),
        "wkv": P((batch, H, hd, hd), ("batch", "heads", None, None),
                 init="zeros", dtype="float32"),
        "cm_shift": P((batch, 1, d), ("batch", None, "embed"), init="zeros"),
    }


def rwkv6_wkv_chunked(r, k, v, logw, u, *, chunk: int = 64):
    """Chunked-parallel RWKV-6 wkv: per-chunk matrix products instead of a
    per-token scan (derivation in ``repro.models.recurrent``).  Per head,
    with clw = cumsum(log w) inside the chunk, the pairwise term uses
    exponents clw_{t-1} - clw_i <= 0, and the factored split clips clw at
    -30 (contributions below e^-30 are zero in f32 anyway).

    r,k,v,logw: [B, S, H, hd] f32; u: [H, hd].  Returns (out, s_last), or
    None when S is not a multiple of the chunk (the caller then scans)."""
    B, S, H, hd = r.shape
    c = min(chunk, S)
    if S % c:
        return None
    n = S // c
    rc, kc, vc, lwc = (t.reshape(B, n, c, H, hd).transpose(0, 1)
                       for t in (r, k, v, logw))
    s = torch.zeros((B, H, hd, hd), dtype=torch.float32, device=r.device)
    mask = torch.tril(torch.ones((c, c), dtype=torch.bool, device=r.device),
                      diagonal=-1)
    outs = []
    for rt, kt, vt, lw in zip(rc, kc, vc, lwc):         # [B, c, H, hd]
        clw = torch.cumsum(lw, dim=1)                   # inclusive
        clw_sh = torch.cat([torch.zeros_like(clw[:, :1]), clw[:, :-1]],
                           dim=1)                       # exclusive
        a = rt * torch.exp(torch.clamp(clw_sh, -30.0, 0.0))
        b = kt * torch.exp(-torch.clamp_min(clw, -30.0))
        out = torch.einsum("bthd,bhdv->bthv", a, s)
        scores = torch.einsum("bthd,bihd->bhti", a, b)
        scores = torch.where(mask[None, None], scores, 0.0)
        out = out + torch.einsum("bhti,bihd->bthd", scores, vt)
        out = out + torch.einsum("bthd,bthd->bth", rt * u[None, None],
                                 kt)[..., None] * vt
        decay_all = torch.exp(torch.clamp(clw[:, -1:], -30.0, 0.0))
        k_dec = kt * torch.exp(torch.clamp(clw[:, -1:] - clw, -30.0, 0.0))
        s = decay_all[:, 0, :, :, None] * s \
            + torch.einsum("bihd,bihv->bhdv", k_dec, vt)
        outs.append(out)
    return torch.stack(outs, dim=1).reshape(B, S, H, hd), s
