"""Recurrent temporal-mix layers (port of ``repro.models.recurrent``): RG-LRU
(RecurrentGemma/Griffin) and RWKV-6 (Finch, data-dependent decay).  Both
have a parallel prefill path and a single-step decode path.

A prefill's scan (no state) takes the route :func:`scan_route` names from
``use_kernel``: ``True`` sends it to the port's kernel wrapper
(``kernels.ops``: K4 / K5 on the card, their plain twins on the CPU), as
the JAX layers send it to the Pallas kernel; ``False`` runs the plain form,
the JAX package's default.  ``None``, the default here and the model's,
runs the kernel where it can: on CUDA operands outside autograd (no
operand needs a gradient under grad mode).  On the CPU, on the meta device
(a dry run counts the plain loop) and under a gradient (the kernels have
no backward pass) it runs the plain form; an explicit
``cfg.rwkv_impl="chunked"`` comes first.  Decode (a state, one step) is the
same on every route.

On a mesh (``lay``, a :class:`~repro_torch.sharding.layout.Layout`) both
are tensor-parallel blocks on a rank's shards, split as the rules split
their weights ('mlp', 'heads_x' over 'model'), with no product computed
twice: the sequence is gathered as attention gathers it, a rank runs the
scan on its own channels (RG-LRU) or on the heads its channels touch
(RWKV-6), and the row-parallel output projection's partial sums meet in
``shard_act``.  A rank's decode state is its own channels.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import rglru_scan_ref, rwkv6_scan_ref
from repro_torch.sharding import comm
from repro_torch.sharding.layout import seq_gather, seq_rows, tp_sharded

from .base import ModelConfig, P
from .layers import _w, shard_act


def scan_route(use_kernel: bool | None, device, requires_grad: bool,
               rwkv_impl: str = "scan") -> str:
    """Where a prefill's scan runs: ``"kernel"`` (``kops.rglru_scan`` /
    ``kops.rwkv6_scan``), ``"chunked"`` (RWKV-6's chunked form) or
    ``"plain"`` (``rglru_scan_ref`` / ``rwkv6_scan_ref``).

    ``use_kernel`` True or False is the JAX package's switch, the kernel
    before ``rwkv_impl`` as in its branch order.  ``None`` takes the kernel
    only on a CUDA ``device`` with no operand that ``requires_grad`` under
    grad mode, after an explicit ``rwkv_impl="chunked"``.  Chosen from the
    operands before any launch: nothing falls back after an error."""
    if use_kernel is None:
        if rwkv_impl == "chunked":
            return "chunked"
        needs_grad = requires_grad and torch.is_grad_enabled()
        use_kernel = torch.device(device).type == "cuda" and not needs_grad
    if use_kernel:
        return "kernel"
    return "chunked" if rwkv_impl == "chunked" else "plain"


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


def _rglru_coeffs(params, xb, lay=None):
    """Per-step recurrence coefficients a_t, b_t (f32) from branch input xb.
    The sigmoids run in xb's dtype, the rest in f32.

    On a mesh xb is this rank's channels and gate_a / gate_i its row
    blocks: each product is a partial sum over the full width, which is
    reduce-scattered onto the rank's channels before the sigmoid."""
    r = xb @ _w(params, "gate_a", lay).to(xb.dtype)
    i = xb @ _w(params, "gate_i", lay).to(xb.dtype)
    if lay is not None:      # contiguous channels, as K4 reads them
        r, i = (comm.scatter(t, 2, lay.model).contiguous() for t in (r, i))
    r, i = torch.sigmoid(r), torch.sigmoid(i)
    log_a = _C_LOG_A * F.softplus(_w(params, "log_lambda", lay).float()) \
        * r.float()
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i.float() * xb.float())
    return a, b


def _conv1d(params, x, state=None, lay=None):
    """Causal depthwise conv along time, taps summed in tap order.  x: [B,
    S, w]; state: the last cw-1 inputs (decode).  ``cat`` promotes x and
    the state to a common dtype, as ``jnp.concatenate`` does.  Depthwise,
    so on a mesh it runs on the rank's channels as it is."""
    conv_w = _w(params, "conv_w", lay)
    cw = conv_w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], cw - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    out = xp[:, 0:S] * conv_w[0].to(x.dtype)
    for i in range(1, cw):
        out = out + xp[:, i:i + S] * conv_w[i].to(x.dtype)
    new_state = xp[:, xp.shape[1] - (cw - 1):]
    return out + _w(params, "conv_b", lay).to(x.dtype), new_state


def rglru(params, x, *, cfg: ModelConfig, state=None,
          use_kernel: bool | None = None, lay=None):
    """x: [B, S, d].  state = dict(conv=[B,cw-1,w], h=[B,w]) for decode.

    Returns (out [B,S,d], new_state); the state's h is the last step
    rounded to x's dtype, then f32, as in the JAX package.

    On a mesh (``lay``) the LRU width is split over 'model' (the rules'
    'mlp'): x is this rank's residual rows, gathered to every position;
    in_x / in_y are column blocks, so the branch, the conv, the scan and
    the state hold the rank's w/tp channels; gate_a / gate_i are row
    blocks (:func:`_rglru_coeffs`); ``out``'s row block gives a partial
    sum over 'model', combined into the residual layout."""
    if lay is not None:
        assert all(tp_sharded(getattr(params, n), dim) for n, dim in (
            ("in_x", 1), ("in_y", 1), ("gate_a", 0), ("out", 0))) \
            or lay.tp == 1, "RG-LRU on a mesh takes the rules' 'mlp' split"
        x = seq_gather(x, lay)
    gx = F.gelu(x @ _w(params, "in_x", lay).to(x.dtype), approximate="tanh")
    xb = x @ _w(params, "in_y", lay).to(x.dtype)
    xb, conv_state = _conv1d(params, xb, None if state is None
                             else state["conv"], lay)
    a, b = _rglru_coeffs(params, xb, lay)

    if state is None:
        kernel = scan_route(use_kernel, a.device, a.requires_grad
                            or b.requires_grad) == "kernel"
        h = kops.rglru_scan(a, b) if kernel else rglru_scan_ref(a, b)
    else:
        h = a * state["h"][:, None, :] + b        # S == 1
    h = h.to(x.dtype)
    out = (gx * h) @ _w(params, "out", lay).to(x.dtype)
    return shard_act(out, lay), {"conv": conv_state,
                                 "h": h[:, -1, :].float()}


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
                   use_kernel: bool | None = None, lay=None):
    """x: [B, S, d]. state = dict(shift=[B,1,d], wkv=[B,H,hd,hd]).
    On a mesh (``lay``) see :func:`_time_mix_tp`."""
    if lay is not None:
        return _time_mix_tp(p, x, cfg=cfg, state=state,
                            use_kernel=use_kernel, lay=lay)
    B, S, d = x.shape
    hd = cfg.rwkv_head_dim
    H = d // hd
    xs = _token_shift(x, None if state is None else state["shift"])
    dx = xs - x
    mu = _lora_mu(p, x, None)
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
    out, s_last = _wkv(cfg, rf, kf, vf, w, logw.reshape(B, S, H, hd), u,
                       None if state is None else state["wkv"], use_kernel)

    # group norm over heads (ln_x; population variance), then gate
    out = _group_norm(out.to(x.dtype)).reshape(B, S, d)
    out = out * p.ln_x.to(x.dtype)
    out = (out * g) @ p.wo.to(x.dtype)
    return out, {"shift": x[:, -1:, :], "wkv": s_last}


def _lora_mu(p, x, lay):
    """The Finch data-dependent interpolation weights [5, B, S, d]:
    ``mu_base + tanh(x @ lora_a) @ lora_b``, in x's dtype.

    On a mesh lora_a / lora_b are column / row blocks of the LoRA width
    ('mlp'): a rank's product is a partial sum over its block, rounded to
    x's dtype, and the partials are all-reduced over 'model', as the JAX
    package's partitioned program rounds its dot's partial results.  In
    bf16 that is more roundings than one rank's single product, and
    their error is what sets a mesh's bf16 training step apart from one
    rank's (``tests/test_torch_steps.py``)."""
    lx = torch.tanh(x @ _w(p, "lora_a", lay).to(x.dtype))
    part = torch.einsum("bsl,nld->nbsd", lx,
                        _w(p, "lora_b", lay).to(x.dtype))
    if lay is not None:
        part = comm.psum(part, lay.model)
    return _w(p, "mu_base", lay).to(x.dtype)[:, None, None, :] + part


def _wkv(cfg: ModelConfig, r, k, v, w, logw, u, s0,
         use_kernel: bool | None):
    """The wkv recurrence of [B, S, H, hd] f32 operands: a prefill on the
    route :func:`scan_route` names (K5, the chunked form, or the per-token
    scan; a sequence the chunks do not divide takes the route without
    them), a decode by the per-token scan from ``s0``.  Returns (out,
    s_last)."""
    if s0 is None:
        grad = any(t.requires_grad for t in (r, k, v, w, u))
        route = scan_route(use_kernel, r.device, grad, cfg.rwkv_impl)
        if route == "chunked":
            ch = rwkv6_wkv_chunked(r, k, v, logw, u, chunk=cfg.rwkv_chunk)
            if ch is not None:
                return ch
            route = scan_route(use_kernel, r.device, grad)
        if route == "kernel":
            return kops.rwkv6_scan(r, k, v, w, u)
    return rwkv6_scan_ref(r, k, v, w, u, s0=s0)


_LN_X_EPS = 64e-5


def _group_norm(out):
    """ln_x: each head's hd channels normalized by their mean and
    population variance.  out: [B, S, H, hd]."""
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    return (out - mean) * torch.rsqrt(var + _LN_X_EPS)


def _group_norm_split(out, own, h0: int, H: int, lay):
    """:func:`_group_norm` of the heads [h0, h0 + nh) when this rank holds
    only the channels ``own`` ([nh, hd] bool) of them: each head's sum and
    then its sum of squared deviations are partial sums over the ranks
    that share it, combined over 'model' as [B, S, H] (f32; the mean and
    variance then rounded to out's dtype, as ``mean`` / ``var`` round
    them).  Channels outside ``own`` come out as garbage, not used."""
    nh, hd = own.shape

    def head_sum(t):
        part = F.pad(torch.where(own, t, 0.0).sum(-1), (h0, H - h0 - nh))
        return comm.psum(part, lay.model)[..., h0:h0 + nh, None]

    of = out.float()
    mean = head_sum(of) / hd
    var = head_sum(torch.square(of - mean)) / hd
    return (out - mean.to(out.dtype)) * torch.rsqrt(
        var.to(out.dtype) + _LN_X_EPS)


def _time_mix_tp(p, x, *, cfg: ModelConfig, state,
                 use_kernel: bool | None, lay):
    """The RWKV-6 time mix on a mesh.  The rules split wr, wk, wv, wg
    (columns) and wo (rows) on 'heads_x': rank r owns the d/tp channels
    [c0, c1) = [r d/tp, (r+1) d/tp), whole heads when tp divides the
    heads, else a block that may start or end inside a head.

    The wkv recurrence is independent across value channels, so a rank
    computes the outputs of its own channels exactly: it projects r, k,
    v and g on its own columns, all-gathers r and k over 'model' for the
    rest of the heads [h0, h1) its block touches (only when a head is
    split), and scans those heads with v zero outside its channels (on
    the route :func:`scan_route` names: K5, the chunked or the per-token
    form); the outputs of its own channels are the one-rank ones, the
    others zero.
    The decay and the interpolation weights come whole from the LoRA
    paths (lora_a / decay_a column blocks and lora_b / decay_b row
    blocks on 'mlp', their partial sums all-reduced over 'model').  ln_x
    is local when the heads are whole and combines a split head's sums
    over 'model' otherwise (:func:`_group_norm_split`); wo's row block
    gives the partial sum that ``shard_act`` combines.

    The state on a mesh: ``shift`` is the rank's channels of the last
    input [B, 1, d/tp]; ``wkv`` is value-major, [B, hd, d/tp]: the rank's
    value channels of the heads it touches (entry [b, i, j] is S[b, h,
    i, jj] for its channel j = h hd + jj), so a split head's state has
    no copy on two ranks."""
    hd = cfg.rwkv_head_dim
    x = seq_gather(x, lay)
    B, S, d = x.shape
    H, tp = d // hd, lay.tp
    assert d % tp == 0 and all(tp_sharded(getattr(p, n), dim) for n, dim in (
        ("wr", 1), ("wk", 1), ("wv", 1), ("wg", 1), ("wo", 0))) or tp == 1, \
        "RWKV-6 on a mesh takes the rules' 'heads_x' split"
    c0 = lay.tp_rank * (d // tp)
    c1 = c0 + d // tp
    h0, h1 = c0 // hd, -(-c1 // hd)
    a, b = h0 * hd, h1 * hd                     # the touched heads' channels
    nh = h1 - h0
    last = None if state is None else comm.gather(state["shift"], 2,
                                                  lay.model)
    xs = _token_shift(x, last)
    dx = xs - x
    mu = _lora_mu(p, x, lay)
    xr, xk, xv, xg, xw = [x + dx * mu[i] for i in range(5)]

    r, k, v = (xi @ _w(p, n, lay).to(x.dtype)
               for xi, n in ((xr, "wr"), (xk, "wk"), (xv, "wv")))
    g = F.silu(xg @ _w(p, "wg", lay).to(x.dtype))
    dw = comm.psum(torch.tanh(xw @ _w(p, "decay_a", lay).to(x.dtype))
                   @ _w(p, "decay_b", lay).to(x.dtype), lay.model)
    logw = -torch.exp(torch.clamp(
        _w(p, "decay_base", lay).float()[a:b] + dw[..., a:b].float(),
        -8.0, 4.0)).reshape(B, S, nh, hd)
    split = (a, b) != (c0, c1)
    if split:                # contiguous channels, as K5 reads them
        rk = comm.gather(torch.stack((r, k)), 3, lay.model)[..., a:b]
        r, k = rk[0].contiguous(), rk[1].contiguous()
        v = F.pad(v, (c0 - a, b - c1))
    rf, kf, vf = (t.float().reshape(B, S, nh, hd) for t in (r, k, v))
    u = _w(p, "bonus", lay, model=True).float()[h0:h1]
    s0 = None
    if state is not None:                       # value-major -> per head
        s0 = F.pad(state["wkv"], (c0 - a, b - c1)).reshape(
            B, hd, nh, hd).transpose(1, 2)
    out, s_last = _wkv(cfg, rf, kf, vf, torch.exp(logw), logw, u, s0,
                       use_kernel)
    out = out.to(x.dtype)
    if split:
        own = torch.zeros(b - a, dtype=torch.bool, device=x.device)
        own[c0 - a:c1 - a] = True
        out = _group_norm_split(out, own.reshape(nh, hd), h0, H, lay)
    else:
        out = _group_norm(out)
    out = out.reshape(B, S, b - a)[..., c0 - a:c1 - a]
    out = out * _w(p, "ln_x", lay).to(x.dtype)[c0:c1]
    out = (out * g) @ _w(p, "wo", lay).to(x.dtype)
    wkv = s_last.transpose(1, 2).reshape(B, hd, b - a)[..., c0 - a:c1 - a]
    return shard_act(out, lay), {"shift": x[:, -1:, c0:c1],
                                 "wkv": wkv.contiguous()}


def rwkv6_channel_mix(p, x, *, state=None, lay=None):
    """The channel mix.  On a mesh: the sequence gathered; wk a column
    block and wv a row block on 'mlp', so ``k @ wv`` is a partial sum over
    'model', combined into the residual layout before the gate
    multiplies it; the gate ``r`` (wr a column block on 'heads_x') is
    all-gathered on its channels and cut to the residual rows.  The shift
    state is the rank's channels, as the time mix's."""
    if lay is None:
        xs = _token_shift(x, None if state is None else state["shift"])
        dx = xs - x
        xk = x + dx * p.mu_k.to(x.dtype)
        xr = x + dx * p.mu_r.to(x.dtype)
        k = torch.square(torch.relu(xk @ p.wk.to(x.dtype)))
        r = torch.sigmoid(xr @ p.wr.to(x.dtype))
        out = r * (k @ p.wv.to(x.dtype))
        return out, {"shift": x[:, -1:, :]}
    x = seq_gather(x, lay)
    c = x.shape[2] // lay.tp
    c0 = lay.tp_rank * c
    last = None if state is None else comm.gather(state["shift"], 2,
                                                  lay.model)
    xs = _token_shift(x, last)
    dx = xs - x
    xk = x + dx * _w(p, "mu_k", lay).to(x.dtype)
    xr = x + dx * _w(p, "mu_r", lay).to(x.dtype)
    k = torch.square(torch.relu(xk @ _w(p, "wk", lay).to(x.dtype)))
    r = torch.sigmoid(xr @ _w(p, "wr", lay).to(x.dtype))
    kv = shard_act(k @ _w(p, "wv", lay).to(x.dtype), lay)
    out = seq_rows(comm.gather(r, 2, lay.model), lay) * kv
    return out, {"shift": x[:, -1:, c0:c0 + c]}


def rwkv6_state_struct(cfg: ModelConfig, batch: int, tp_layout: bool = False):
    """The decode state.  ``tp_layout``: the layout of the state on a mesh
    (:func:`_time_mix_tp`), ``wkv`` value-major [batch, hd, d], whose
    'embed' the cache rules split over 'model' as they split the shifts."""
    d, hd = cfg.d_model, cfg.rwkv_head_dim
    H = d // hd
    wkv = (P((batch, hd, d), ("batch", None, "embed"), init="zeros",
             dtype="float32") if tp_layout else
           P((batch, H, hd, hd), ("batch", "heads", None, None),
             init="zeros", dtype="float32"))
    return {
        "tm_shift": P((batch, 1, d), ("batch", None, "embed"), init="zeros"),
        "wkv": wkv,
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
