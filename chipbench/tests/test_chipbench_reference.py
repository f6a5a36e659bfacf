"""The plain references against the program's CPU path at the two
configurations' smoke sizes, both in f32 on the same weights.

Tolerance 2e-4 of the largest logit (and of each cache leaf's largest
entry): both sides compute in f32 but add in other orders (the program's
attention runs K3's plain twin tile by tile, the reference whole rows; the
RWKV-6 scan runs a token at a time in the program, a chunk of 64 in closed
form in the reference), which at these depths parts them by a few 1e-6 of
the largest value; a real difference (a wrong mask, rotation, gate, decay
or norm) moves them by 1e-2 or more."""
from __future__ import annotations

import pytest
import torch

from chipbench import weights
from chipbench.loops.closed_prefill import port_config
from chipbench.reference import moe, rwkv
from chipbench.tests.smoke_root import smoke_conf

RTOL = 2e-4
REFS = {"deepseek-moe-16b": moe, "rwkv6-3b": rwkv}


def _program_and_reference(name: str, seed: int, B: int = 2, S: int = 48):
    from repro_torch.launch.steps import prefill
    from repro_torch.models import Transformer, model_struct
    conf = smoke_conf(name)
    cfg = port_config(conf).replace(attn_dtype="f32")
    gen = torch.Generator().manual_seed(seed)
    tree = weights.draw(model_struct(cfg), conf["draw"], gen, torch.float32,
                        "cpu")
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           dtype=torch.int32)
    logits, caches = prefill(Transformer(cfg, tree), cfg, {"tokens": tokens})
    ref_logits, ref_caches = REFS[name].forward(tree, conf, tokens)
    return logits, caches, ref_logits, ref_caches


@pytest.mark.parametrize("name", sorted(REFS))
@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7])
def test_reference_logits_match_program_f32(name, seed):
    logits, _, ref, _ = _program_and_reference(name, seed)
    assert logits.shape == ref.shape
    err = (logits - ref).abs().max() / ref.abs().max()
    assert err <= RTOL, err


@pytest.mark.parametrize("name", sorted(REFS))
def test_reference_caches_match_program_f32(name):
    from chipbench.check import _layer_caches
    _, caches, _, ref = _program_and_reference(name, 3)
    for row in range(2):
        got = _layer_caches(caches, row)
        assert len(got) == len(ref)
        for mine, want in zip(got, ref):
            assert set(mine) == set(want)
            for k, t in mine.items():
                w = want[k][row]
                assert t.shape == w.shape, k
                assert (t - w).abs().max() <= RTOL * w.abs().max(), k


def test_reference_moe_drops_what_the_program_drops():
    """A routing group smaller than the experts' slots: the capacity
    formula, and every expert keeping its earliest tokens."""
    m = {"n_experts": 8, "experts_per_token": 3, "capacity_factor": 1.25}
    assert moe.capacity(48, m) == 24 and moe.capacity(4, m) == 4
    from repro_torch.models.moe import _capacity
    cfg = port_config(smoke_conf("deepseek-moe-16b"))
    for tokens in (4, 48, 512, 2048):
        mm = dict(m, n_experts=64, experts_per_token=6)
        assert moe.capacity(tokens, mm) == _capacity(
            tokens, cfg.replace(n_experts=64, experts_per_token=6))


def test_rwkv_chunked_wkv_equals_the_recurrence():
    """The reference's closed form against the recurrence written out a
    token at a time, across chunk boundaries and with long memories."""
    gen = torch.Generator().manual_seed(5)
    N, S, H, hd = 2, 150, 3, 8
    r, k, v = (torch.randn(N, S, H, hd, generator=gen) for _ in range(3))
    logw = -torch.exp(torch.empty(N, S, H, hd).uniform_(-6, 1,
                                                        generator=gen))
    u = torch.randn(H, hd, generator=gen)
    out, s_last = rwkv.wkv(r, k, v, logw, u)
    s = torch.zeros(N, H, hd, hd)
    want = []
    for t in range(S):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        want.append(torch.einsum("nhd,nhde->nhe", r[:, t],
                                 s + u[None, :, :, None] * kv))
        s = torch.exp(logw[:, t])[..., None] * s + kv
    want = torch.stack(want, dim=1)
    # f32 sums in two orders: 1e-5 of the largest value
    assert (out - want).abs().max() <= 1e-5 * want.abs().max()
    assert (s_last - s).abs().max() <= 1e-5 * s.abs().max()
