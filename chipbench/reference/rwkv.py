"""Plain float32 reference of the RWKV-6 (Finch) decoder as the benchmark's
configuration states it (``configs/rwkv6-3b.json``, with its departures):
per layer an RMSNorm, the time mix (token shift, the LoRA interpolations,
r, k, v and the SiLU gate, the data-dependent decay, the wkv recurrence
with its bonus, a group norm per head and ln_x, the output projection),
then an RMSNorm and the channel mix (token shift, relu(k)^2, the sigmoid
receptance); a final RMSNorm and the LM head.

The wkv recurrence, per head, with S_0 = 0:
    out_t = r_t . (S_{t-1} + diag(u) k_t v_t^T),
    S_t = diag(w_t) S_{t-1} + k_t v_t^T,
is computed a chunk of tokens at a time in closed form: within a chunk
every decay product is exp of a difference of cumulative log decays that
is never positive, so nothing overflows and nothing is cut off.

Written from the paper's equations, independent of the program: plain
PyTorch, f32 with TF32 off, whole sequences at once.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import EXACT, at, f32_no_tf32, layers, rmsnorm

CHUNK = 64
GROUP_NORM_EPS = 64e-5


def shift(x):
    """x[t - 1] at t, zeros at t = 0."""
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, logw, u, chunk: int = CHUNK):
    """r, k, v, logw [N, S, H, hd] f32; u [H, hd].  Returns (out [N, S, H,
    hd], the last state [N, H, hd, hd])."""
    N, S, H, hd = r.shape
    s = r.new_zeros(N, H, hd, hd)
    outs = []
    for c0 in range(0, S, chunk):
        rc, kc, vc, lw = (t[:, c0:c0 + chunk] for t in (r, k, v, logw))
        c = rc.shape[1]
        incl = torch.cumsum(lw, dim=1)             # log prod w_0 .. w_t
        excl = incl - lw                           # log prod w_0 .. w_{t-1}
        # the state carried in, decayed to each token
        out = torch.einsum("nthd,nhde->nthe", rc * torch.exp(excl), s)
        # earlier tokens of the chunk: i < t, exponent excl_t - incl_i <= 0
        past = torch.ones(c, c, dtype=torch.bool, device=r.device).tril(-1)
        expo = excl[:, :, None] - incl[:, None, :]          # [N, t, i, H, hd]
        expo = expo.masked_fill(~past[None, :, :, None, None], float("-inf"))
        a = torch.einsum("nthd,nihd,ntihd->nhti", rc, kc, torch.exp(expo))
        out = out + torch.einsum("nhti,nihe->nthe", a, vc)
        # the token itself, with the bonus
        out = out + (rc * u * kc).sum(-1, keepdim=True) * vc
        outs.append(out)
        dec = torch.exp(incl[:, -1:] - incl)                # to the chunk end
        s = torch.exp(incl[:, -1])[..., None] * s \
            + torch.einsum("nihd,nihe->nhde", kc * dec, vc)
    return torch.cat(outs, dim=1), s


def time_mix(p, x, m: dict, cast):
    N, S, d = x.shape
    hd = m["rwkv_head_dim"]
    H = d // hd
    dx = shift(x) - x
    lx = torch.tanh(x @ cast.mat(p["lora_a"]))
    mu = p["mu_base"].float()[:, None, None] \
        + torch.einsum("nsl,cld->cnsd", lx, cast.mat(p["lora_b"]))
    xr, xk, xv, xg, xw = (x + dx * mu[i] for i in range(5))
    r, k, v = ((xi @ cast.mat(p[n])).reshape(N, S, H, hd)
               for xi, n in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(xg @ cast.mat(p["wg"]))
    dw = torch.tanh(xw @ cast.mat(p["decay_a"])) @ cast.mat(p["decay_b"])
    logw = -torch.exp(torch.clamp(p["decay_base"].float() + dw, -8.0, 4.0))
    out, state = wkv(r, k, v, logw.reshape(N, S, H, hd), p["bonus"].float())
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = ((out - mean) * torch.rsqrt(var + GROUP_NORM_EPS)).reshape(N, S, d)
    out = out * p["ln_x"].float()
    return (out * g) @ cast.mat(p["wo"]), state


def channel_mix(p, x, cast):
    dx = shift(x) - x
    xk = x + dx * p["mu_k"].float()
    xr = x + dx * p["mu_r"].float()
    k = torch.relu(xk @ cast.mat(p["wk"])).square()
    return torch.sigmoid(xr @ cast.mat(p["wr"])) * (k @ cast.mat(p["wv"]))


def forward(tree, conf: dict, tokens, cast=EXACT):
    """tokens [N, S] -> (logits [N, S, vocab] f32, a cache dict per layer:
    ``tm_shift`` and ``cm_shift``, the last position's input to the time
    and channel mix [N, 1, d], and ``wkv``, the last state [N, H, hd,
    hd])."""
    m = conf["model"]
    eps, d = m["norm_eps"], m["d_model"]
    with f32_no_tf32():
        x = cast.rows(tree["embed"]["tok"][tokens.long()]) * math.sqrt(d)
        caches = []
        for lp, r in layers(tree):
            p = at(lp, r)
            h = rmsnorm(x, p["ln1"]["scale"], eps)
            out, state = time_mix(p["tm"], h, m, cast)
            x = x + out
            h2 = rmsnorm(x, p["ln2"]["scale"], eps)
            x = x + channel_mix(p["cm"], h2, cast)
            caches.append({"tm_shift": h[:, -1:], "wkv": state,
                           "cm_shift": h2[:, -1:]})
        x = rmsnorm(x, tree["final_norm"]["scale"], eps)
        logits = x @ cast.mat(tree["head"]["w"])
    return logits[..., :m["vocab_size"]], caches
