"""Affinity hashing of compiled-state locality classes (port of the first
half of ``repro.engine.compile_cache``).

The service's signature-affine routing (:mod:`repro_torch.service.signature`)
needs the token and its shard.  The persistent kernel cache and warm start
of the reference's second half are not ported yet (ROADMAP.md, open items,
item 4).
"""
from __future__ import annotations

import json
import zlib

from repro_torch.core.isa import MachineConfig

__all__ = ["affinity_token", "shard_of_token"]


def _canon_cfg(cfg: MachineConfig) -> str:
    return json.dumps(cfg._asdict(), sort_keys=True, separators=(",", ":"))


def affinity_token(mechanism: str, cfg: MachineConfig,
                   majority_first: bool, pad_len: int) -> str:
    """The stable routing token of one compiled-state locality class.

    Everything that shares a token shares jit/executable cache state
    (mechanism + canonical cfg + scheduling flavor + padding class), so the
    service routes it to one shard and warm-start replays it there.  The
    token is plain text — hash it with :func:`shard_of_token`, never with
    the builtin ``hash`` (randomized per process, useless across a pool).
    """
    return (f"{mechanism}|{_canon_cfg(cfg)}|mf{int(bool(majority_first))}"
            f"|pad{int(pad_len)}")


def shard_of_token(token: str, n_shards: int) -> int:
    """Deterministic shard assignment of a token: crc32 mod ``n_shards``."""
    if n_shards <= 1:
        return 0
    return zlib.crc32(token.encode("utf-8")) % n_shards
