"""Model substrate: configs and structure trees (port of ``repro.models.base``).

Every parameter is declared once as a :class:`P` leaf carrying its shape,
logical axis names and initializer.  A structure tree is nested dicts and
lists of ``P`` leaves laid out exactly as the JAX package lays out its
param trees (stacked ``[L, ...]`` per plan segment), so ``param_count`` and
the init std rule see the same shapes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from repro_torch.device import resolve

# ---------------------------------------------------------------------------
# parameter structure leaves
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class P:
    """A parameter declaration: shape + logical axes + init."""
    shape: tuple[int, ...]
    axes: tuple[str | None, ...]
    init: str = "normal"          # normal | zeros | ones
    scale: float | None = None    # std override for normal
    dtype: str | None = None      # override (default: model param dtype)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a tree of dicts and lists (a
    :class:`PartitionSpec` is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree,
                                                          PartitionSpec):
        return [tree_map(fn, t) for t in tree]
    return fn(tree)


def tree_unflatten(like, leaves):
    """A tree laid out as ``like`` holding ``leaves`` in
    :func:`tree_leaves` order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


def tree_leaves(tree) -> list:
    """The leaves of a tree of dicts and lists in the JAX package's order
    (dict keys sorted, lists in order); a ``None`` is a leaf here."""
    out: list = []
    tree_map(out.append, tree)
    return out


def init_params(struct, generator: torch.Generator | None,
                dtype=torch.float32, device=None, *, mesh=None, specs=None):
    """Materialize a random param tree from a structure tree.

    Normal leaves draw from ``generator`` (which must live on ``device``)
    with the JAX package's std rule: ``leaf.scale`` if set, else 0.02 for
    vectors and ``min(0.02, shape[0] ** -0.5)`` for matrices.  A tree of
    zeros and ones (a decode cache) needs no generator.

    With a ``DeviceMesh`` and a tree of :class:`PartitionSpec` (``specs``)
    each leaf is drawn whole, in the same order and so with the same
    values as on one device, and becomes at once a DTensor holding this
    rank's shard: one whole leaf at a time is resident."""
    dev = resolve(device)
    if mesh is not None:
        from repro_torch.sharding.specs import distribute
        leaves = [distribute(init_params(leaf, generator, dtype, dev), mesh,
                             spec)
                  for leaf, spec in zip(tree_leaves(struct),
                                        tree_leaves(specs), strict=True)]
        return tree_unflatten(struct, leaves)

    def make(leaf: P):
        dt = getattr(torch, leaf.dtype) if leaf.dtype else dtype
        if leaf.init == "zeros":
            return torch.zeros(leaf.shape, dtype=dt, device=dev)
        if leaf.init == "ones":
            return torch.ones(leaf.shape, dtype=dt, device=dev)
        std = leaf.scale
        if std is None:
            fan_in = leaf.shape[0] if leaf.shape else 1
            std = 0.02 if len(leaf.shape) < 2 else min(0.02, fan_in ** -0.5)
        x = torch.randn(leaf.shape, generator=generator, dtype=torch.float32,
                        device=dev)
        # scaled in place: one f32 copy of the leaf at a time, not two
        return x.mul_(std).to(dt)

    return tree_map(make, struct)


class Params(nn.Module):
    """A frozen tree of named parameters: one dict of a param tree, with
    sub-dicts as submodules, so ``lp.attn.wq`` reads as ``lp["attn"]["wq"]``
    does in the JAX package.  Tensors are wrapped, not copied."""

    def __init__(self, tree: dict):
        super().__init__()
        for name, t in tree.items():
            if isinstance(t, dict):
                self.add_module(name, Params(t))
            else:
                self.register_parameter(
                    name, nn.Parameter(t, requires_grad=False))


class PartitionSpec(tuple):
    """A torch-free copy of ``jax.sharding.PartitionSpec``: one entry per
    tensor dimension, each ``None`` (replicated), a mesh axis name, or a
    tuple of mesh axis names (sharded major to minor)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple(self)!r}"


def partition_specs(struct, rules: dict):
    """Logical-axis -> mesh-axis mapping, e.g. {"mlp": "model",
    "embed": "data", "vocab": "model"}.  Unknown axes are replicated.
    A mesh axis may appear at most once per spec; later repeats replicate."""
    def mk(leaf: P):
        used: set = set()
        spec = []
        for ax in leaf.axes:
            m = rules.get(ax)
            flat = tuple(m) if isinstance(m, (tuple, list)) else (m,)
            if m is None or any(f in used for f in flat if f):
                spec.append(None)
            else:
                used.update(f for f in flat if f)
                spec.append(m if not isinstance(m, list) else tuple(m))
        return PartitionSpec(*spec)
    return tree_map(mk, struct)


def sharded_zeros_like_specs(struct, dtype=torch.float32, device=None):
    """A tree of zeros laid out as the structure tree ``struct``."""
    dev = resolve(device)
    return tree_map(
        lambda leaf: torch.zeros(
            leaf.shape, dtype=getattr(torch, leaf.dtype) if leaf.dtype
            else dtype, device=dev), struct)


def param_count(struct) -> int:
    return sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(struct))


# ---------------------------------------------------------------------------
# model configuration
# ---------------------------------------------------------------------------

# layer kinds used in layer plans
GLOBAL, LOCAL, SWA, RECURRENT, RWKV = "global", "local", "swa", "recurrent", "rwkv"
# multi-head latent attention (DeepSeek-V2/V3): the port's own kind
MLA = "mla"


@dataclass(frozen=True)
class ModelConfig:
    """Field for field the JAX package's ``ModelConfig``, so configs compare
    equal, and after them the fields of what only the port runs (latent
    attention, the sigmoid router), whose defaults leave every JAX
    architecture as it is.  The sharded model reads the sharding knobs
    (``batch_axes``, ``act_shard``, ``score_shard``, ``kv_shard``);
    ``tp_impl``'s two values are one path here (``models/shardmap_tp.py``),
    and the dry-run knobs (``rwkv_unroll``, ``scan_layers``) are read by
    nothing in this port."""
    name: str
    family: str                   # dense | moe | hybrid | rwkv | encoder | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int | None = None
    # layer plan: list of (pattern, repeats); sum(len(p)*r) == n_layers
    layer_plan: tuple[tuple[tuple[str, ...], int], ...] = (((GLOBAL,), 0),)
    window_size: int = 0          # for local/swa layers
    causal: bool = True
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # modality frontend stub
    frontend: str = "token"       # token | audio_stub | vision_stub
    frontend_dim: int = 0
    n_patches: int = 0
    # recurrent widths
    lru_width: int = 0
    conv_width: int = 4
    rwkv_head_dim: int = 64
    # misc
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    # runtime knobs
    attn_impl: str = "reference"  # reference | flash
    score_shard: str = "none"
    act_shard: str = "dp"
    attn_dtype: str = "f32"       # f32 | bf16 score/prob materialization
    kv_shard: str = "none"
    rwkv_unroll: int = 1
    tp_impl: str = "gspmd"
    rwkv_impl: str = "scan"
    rwkv_chunk: int = 64
    batch_axes: tuple = ()
    remat: str = "none"
    scan_layers: bool = True
    # port only: multi-head latent attention (``MLA`` layers), DeepSeek-V3's
    # kv_lora_rank, qk_nope_head_dim, qk_rope_head_dim, v_head_dim and the
    # latent's RMSNorm epsilon
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0
    kv_norm_eps: float = 1e-6
    # port only: the MoE router's scoring ("softmax", or "sigmoid" with a
    # correction bias ``e_bias`` that only chooses) and the scale of the
    # sigmoid gates
    router_score: str = "softmax"
    routed_scale: float = 1.0

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded up to a multiple of 256 (logits are sliced back)."""
        return -(-self.vocab_size // 256) * 256

    @property
    def layers_in_plan(self) -> int:
        return sum(len(p) * r for p, r in self.layer_plan)

    @property
    def is_decoder(self) -> bool:
        return self.family != "encoder"

    @property
    def kinds(self) -> tuple[str, ...]:
        out = []
        for pattern, r in self.layer_plan:
            out.extend(list(pattern) * r)
        return tuple(out)

    def validate(self) -> "ModelConfig":
        if self.layers_in_plan != self.n_layers:
            raise ValueError(f"{self.name}: plan covers {self.layers_in_plan} "
                             f"layers, config says {self.n_layers}")
        if self.n_heads % self.n_kv_heads:
            raise ValueError(f"{self.name}: n_heads {self.n_heads} is not a "
                             f"multiple of n_kv_heads {self.n_kv_heads}")
        if MLA in self.kinds and min(self.kv_lora_rank, self.qk_nope_head_dim,
                                     self.qk_rope_head_dim,
                                     self.v_head_dim) <= 0:
            raise ValueError(f"{self.name}: an {MLA!r} layer needs "
                             "kv_lora_rank and the nope, rope and v head "
                             "dims")
        if self.router_score not in ("softmax", "sigmoid"):
            raise ValueError(f"{self.name}: router_score "
                             f"{self.router_score!r}")
        return self

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def uniform_plan(kind: str, n_layers: int):
    return (((kind,), n_layers),)


def cycle_plan(pattern: tuple[str, ...], n_layers: int):
    """Repeat ``pattern`` to cover n_layers, with a trailing remainder."""
    p = len(pattern)
    full, rem = divmod(n_layers, p)
    plan = []
    if full:
        plan.append((tuple(pattern), full))
    if rem:
        plan.append((tuple(pattern[:rem]), 1))
    return tuple(plan)
