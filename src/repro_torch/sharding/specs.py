"""Sharding rule engine (port of ``repro.sharding.specs``): logical axes ->
mesh axes per (arch x shape).

Baseline policy, as the JAX package's:

* 2-D weight sharding everywhere: TP on 'model' (mlp/vocab/heads/experts) x
  FSDP on 'data' (the d_model axis) — optimizer moments inherit it (ZeRO-3);
* activations: batch on ('pod', 'data') (pure DP across pods);
* GQA: shard the q-head axis when divisible by the model-axis size, else
  the head_dim axis;
* MoE: expert-parallel on 'model' when n_experts divides, else TP inside the
  expert ffn;
* decode: KV caches shard batch on data and head_dim on model; the
  batch=1 long-context cell flips to sequence-parallel caches (SP) on 'data'.

The rules read only a mesh's axis names and sizes, so they take an
:class:`AbstractMesh` (no ranks: the production meshes are checked this
way) as well as a ``torch.distributed`` ``DeviceMesh``.
:func:`placements` maps a spec onto a ``DeviceMesh`` as DTensor
placements, in place of the JAX package's ``named``.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.models.base import ModelConfig, PartitionSpec, partition_specs


@dataclass(frozen=True)
class AbstractMesh:
    """Axis names and sizes of a mesh, with no ranks behind it
    (``jax.sharding.AbstractMesh``'s role)."""
    sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of an :class:`AbstractMesh` or a ``DeviceMesh``."""
    if isinstance(mesh, AbstractMesh):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def data_axes(mesh) -> tuple[str, ...]:
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(mesh, name: str) -> int:
    return mesh_shape(mesh).get(name, 1)


def _data_size(mesh) -> int:
    n = 1
    for a in data_axes(mesh):
        n *= _axis_size(mesh, a)
    return n


def logical_rules(cfg: ModelConfig, mesh, *, fsdp: bool = True,
                  overrides: dict | None = None) -> dict:
    """Map logical param axes to mesh axes for this arch."""
    tp = _axis_size(mesh, "model")
    fsdp_ax = "data" if (fsdp and "data" in mesh_shape(mesh)) else None
    rules: dict = {
        "embed": fsdp_ax,
        "mlp": "model",
        "mlp2": None,
        "vocab": "model" if cfg.padded_vocab % tp == 0 else None,
        "heads": "model" if cfg.n_heads % tp == 0 else None,
        "kv_heads": "model" if cfg.n_kv_heads % tp == 0 else None,
        "head_dim": ("model" if (cfg.n_heads % tp and cfg.hd % tp == 0)
                     else None),
        "heads_x": "model",          # rwkv fused d x d projections
        "experts": "model" if (cfg.n_experts and cfg.n_experts % tp == 0)
                   else None,
        "frontend": None,
        "conv": None,
        "layers": None,
    }
    if overrides:
        rules.update(overrides)
    return rules


def param_pspecs(struct, cfg: ModelConfig, mesh, *, fsdp: bool = True,
                 overrides: dict | None = None):
    return partition_specs(struct, logical_rules(cfg, mesh, fsdp=fsdp,
                                                 overrides=overrides))


def batch_pspec(cfg: ModelConfig, mesh, batch: int) -> dict:
    """PartitionSpecs for each batch field (tokens/labels/frames/...)."""
    dax = data_axes(mesh)
    b = tuple(dax) if (dax and batch % _data_size(mesh) == 0) else None
    return {
        "tokens": PartitionSpec(b, None),
        "labels": PartitionSpec(b, None),
        "loss_mask": PartitionSpec(b, None),
        "frames": PartitionSpec(b, None, None),
        "patches": PartitionSpec(b, None, None),
    }


def cache_pspecs(cstruct, cfg: ModelConfig, mesh, batch: int,
                 *, overrides: dict | None = None):
    """Decode-cache sharding.  batch-shardable -> DP over batch + TP over
    head_dim/embed; batch=1 (long-context) -> sequence-parallel cache."""
    dax = data_axes(mesh)
    batch_ok = bool(dax) and batch % _data_size(mesh) == 0
    tp = _axis_size(mesh, "model")
    rules = {
        "batch": tuple(dax) if batch_ok else None,
        "cache_seq": None if batch_ok else "data",     # SP for batch=1
        "kv_heads": "model" if cfg.n_kv_heads % tp == 0 else None,
        "head_dim": ("model" if cfg.n_kv_heads % tp else None),
        "embed": "model" if cfg.d_model % tp == 0 else None,
        "mlp": "model",
        "heads": "model" if cfg.n_heads % tp == 0 else None,
        "layers": None,
    }
    if overrides:
        rules.update(overrides)
    return [partition_specs(cs, rules) for cs in cstruct]


def placements(mesh, spec: PartitionSpec) -> list:
    """DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(dim)`` on
    each mesh dimension that the spec names at tensor dimension ``dim``,
    ``Replicate()`` elsewhere.  A tensor dimension with several mesh axes
    is sharded major to minor, as in JAX; DTensor splits a dimension over
    several mesh dimensions in mesh order, so the axes must be listed in
    that order."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes if a in names]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} at dim {dim} are not in "
                             f"the mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def local_chunk(full, mesh, pl):
    """This rank's shard of a tensor that every rank holds whole, under
    placements ``pl`` (sharded dimensions split evenly, mesh dimension 0
    outermost), as its own copy."""
    coord = mesh.get_coordinate()
    out = full
    for i, p in enumerate(pl):
        if p.is_shard():
            n = mesh.size(i)
            assert out.shape[p.dim] % n == 0, (full.shape, pl)
            out = out.chunk(n, p.dim)[coord[i]]
    return out.clone()


def distribute(full, mesh, spec: PartitionSpec):
    """A DTensor of ``full`` (whole on every rank) laid out as ``spec``:
    each rank keeps its own shard, and nothing is communicated."""
    from torch.distributed.tensor import DTensor

    pl = placements(mesh, spec)
    return DTensor.from_local(local_chunk(full, mesh, pl), mesh, pl,
                              run_check=False, shape=full.shape,
                              stride=full.stride())


def local_batch(batch: dict, cfg: ModelConfig, mesh) -> dict:
    """This rank's part of a global batch: each field laid out by its
    :func:`batch_pspec` (the batch rows of this rank's data coordinate);
    a field without a spec (``positions``) whole."""
    specs = batch_pspec(cfg, mesh, next(iter(batch.values())).shape[0])
    return {k: local_chunk(v, mesh, placements(mesh, specs[k]))
            if k in specs else v for k, v in batch.items()}
