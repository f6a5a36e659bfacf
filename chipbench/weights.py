"""Weights drawn by the benchmark from ``--seed``, on the device, in the
dtype they are served in, laid out as the program's parameter tree.

The tree's shapes and layout come from the program's ``model_struct``; the
values are the benchmark's own.  Every floating leaf is a view of one flat
buffer, drawn from a normal distribution in one call; each leaf is then
scaled by the port's initialisation rule (``P.scale``, else 0.02 for a
vector and min(0.02, shape[0] ** -0.5) for a matrix), or set to its
declared ones or zeros, or drawn uniformly from the range the
configuration's ``draw`` names for its key (norm scales, token-shift mixes,
decays, bonuses: values the check has to see move).
"""
from __future__ import annotations

import math

import torch


def leaves(struct, path=()):
    """(path, leaf) pairs of a structure tree of dicts and lists, dict keys
    sorted, lists in order."""
    if isinstance(struct, dict):
        for k in sorted(struct):
            yield from leaves(struct[k], path + (k,))
    elif isinstance(struct, (list, tuple)):
        for i, s in enumerate(struct):
            yield from leaves(s, path + (i,))
    else:
        yield path, struct


def draw(struct, draw_ranges: dict, generator: torch.Generator,
         dtype: torch.dtype, device) -> dict:
    """A parameter tree laid out as ``struct`` (the program's structure tree
    of ``P`` leaves), every leaf a view of one buffer drawn with
    ``generator`` on ``device``."""
    total = sum(math.prod(leaf.shape) for _, leaf in leaves(struct))
    buf = torch.empty(total, dtype=dtype, device=device)
    buf.normal_(generator=generator)
    at = 0

    def make(name, leaf):
        nonlocal at
        n = math.prod(leaf.shape)
        t = buf[at:at + n].view(leaf.shape)
        at += n
        rng = draw_ranges.get(name)
        if rng is not None:
            t.uniform_(rng[0], rng[1], generator=generator)
        elif leaf.init == "ones":
            t.fill_(1)
        elif leaf.init == "zeros":
            t.zero_()
        else:
            std = leaf.scale
            if std is None:
                std = 0.02 if len(leaf.shape) < 2 else min(
                    0.02, leaf.shape[0] ** -0.5)
            t.mul_(std)
        return t

    def walk(node, name=None):
        # the order of leaves(): dict keys sorted, lists in order
        if isinstance(node, dict):
            return {k: walk(node[k], k) for k in sorted(node)}
        if isinstance(node, (list, tuple)):
            return [walk(s, name) for s in node]
        return make(name, node)

    return walk(struct)
