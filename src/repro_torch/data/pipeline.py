"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``).

It is numpy only, as the JAX package's is, so it returns the same arrays
bit for bit; the caller moves them to its device.

Real corpora are not available offline, so the pipeline synthesizes token
streams with a counter-based PRNG (Philox via numpy) keyed by
(seed, step, shard).  Determinism properties the training runtime relies on:

* restart safety: batch(step) is a pure function of (seed, step), so a
  resumed run replays the exact stream (checkpoint/restart tests assert
  bit-identical batches);
* elastic resharding: the global batch is always materialized as the same
  logical array regardless of host count; hosts slice their shard, so a run
  rescaled to a different mesh sees the same data order;
* packing: documents of geometric length are packed back-to-back with EOS
  separators, mimicking LM pretraining pipelines (loss masks included).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from repro_torch.models.base import ModelConfig


@dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = 1
    pad_id: int = 0


def _rng(seed: int, step: int, tag: int = 0) -> np.random.Generator:
    key = (seed << 40) ^ (step << 8) ^ tag ^ 0x5eed
    return np.random.default_rng(np.random.Philox(key=[key, 0x9e3779b9]))


def _packed_tokens(rng: np.random.Generator, batch: int, seq: int,
                   vocab: int, dc: DataConfig) -> tuple[np.ndarray, np.ndarray]:
    """Pack 'documents' with LEARNABLE structure: Zipfian unigrams plus
    phrase repetition (each document repeats a short random phrase), so a
    model that learns to copy context drops its loss well below the uniform
    entropy — giving the examples/tests a real convergence signal."""
    V = max(4, vocab)
    # zipf-ish unigram table (deterministic per vocab)
    ranks = np.arange(2, V, dtype=np.float64)
    probs = 1.0 / ranks
    probs /= probs.sum()
    toks = np.empty((batch, seq), np.int32)
    for b in range(batch):
        pos = 0
        while pos < seq:
            plen = int(rng.integers(4, 17))
            phrase = rng.choice(ranks.astype(np.int64), size=plen,
                                p=probs).astype(np.int32)
            reps = int(rng.integers(2, 6))
            doc = np.concatenate([np.tile(phrase, reps), [dc.eos_id]])
            n = min(len(doc), seq - pos)
            toks[b, pos:pos + n] = doc[:n]
            pos += n
    mask = np.ones((batch, seq), np.float32)
    return toks, mask


def synthetic_batch(cfg: ModelConfig, batch: int, seq: int, *,
                    step: int = 0, dc: DataConfig = DataConfig()) -> dict:
    """One global batch as numpy arrays (host side, shardable)."""
    rng = _rng(dc.seed, step)
    if cfg.frontend == "audio_stub":
        frames = rng.standard_normal(
            (batch, seq, cfg.frontend_dim)).astype(np.float32)
        labels = rng.integers(0, cfg.vocab_size, size=(batch, seq),
                              dtype=np.int32)
        return {"frames": frames, "labels": labels}
    if cfg.frontend == "vision_stub":
        n_txt = seq - cfg.n_patches
        toks, mask = _packed_tokens(rng, batch, n_txt, cfg.vocab_size, dc)
        patches = rng.standard_normal(
            (batch, cfg.n_patches, cfg.frontend_dim)).astype(np.float32)
        return {"tokens": toks, "patches": patches, "labels": toks,
                "loss_mask": mask}
    toks, mask = _packed_tokens(rng, batch, seq, cfg.vocab_size, dc)
    return {"tokens": toks, "labels": toks, "loss_mask": mask}


class SyntheticPipeline:
    """Step-indexed pipeline with background prefetch and host sharding."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int, *,
                 dc: DataConfig = DataConfig(), host_index: int = 0,
                 host_count: int = 1, prefetch: int = 2):
        assert batch % host_count == 0
        self.cfg, self.batch, self.seq, self.dc = cfg, batch, seq, dc
        self.host_index, self.host_count = host_index, host_count
        self._cache: dict[int, dict] = {}
        self._lock = threading.Lock()
        self._prefetch = prefetch

    def _shard(self, full: dict) -> dict:
        n = self.batch // self.host_count
        lo = self.host_index * n
        return {k: v[lo:lo + n] for k, v in full.items()}

    def get(self, step: int) -> dict:
        with self._lock:
            if step in self._cache:
                return self._cache.pop(step)
        out = self._shard(synthetic_batch(self.cfg, self.batch, self.seq,
                                          step=step, dc=self.dc))
        # opportunistic synchronous prefetch of the next batches
        with self._lock:
            for s in range(step + 1, step + 1 + self._prefetch):
                if s not in self._cache and len(self._cache) < 4:
                    self._cache[s] = self._shard(synthetic_batch(
                        self.cfg, self.batch, self.seq, step=s, dc=self.dc))
        return out
