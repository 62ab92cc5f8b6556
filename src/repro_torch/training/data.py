"""Synthetic data pipeline: deterministic, shardable, infinite.

Sequences are generated from a per-shard PRNG keyed by (seed, step, shard),
so any host can regenerate exactly its shard of any step — the property the
checkpoint/restart path relies on (restart mid-epoch without data state).
A Zipf token distribution keeps embedding-gather access patterns realistic,
and for MoE archs a topic-mixture structure gives the router non-trivial,
stable expert specialization (mirroring serving/workload.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.configs.base import ArchConfig

__all__ = ["DataConfig", "synthetic_batch", "data_stream"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 128
    global_batch: int = 8
    seed: int = 0
    zipf_a: float = 1.2
    n_topics: int = 16


def _zipf_probs(vocab: int, a: float) -> np.ndarray:
    p = 1.0 / np.arange(1, vocab + 1) ** a
    return p / p.sum()


_PROB_CACHE: Dict[tuple, np.ndarray] = {}


def synthetic_batch(cfg: ArchConfig, data: DataConfig, step: int,
                    shard: int = 0, n_shards: int = 1) -> Dict[str, np.ndarray]:
    """One (possibly host-sharded) batch for the given step."""
    rng = np.random.default_rng(
        np.random.SeedSequence([data.seed, step, shard]))
    b = data.global_batch // n_shards
    s = data.seq_len
    key = (cfg.vocab, data.zipf_a)
    if key not in _PROB_CACHE:
        _PROB_CACHE[key] = _zipf_probs(cfg.vocab, data.zipf_a)
    probs = _PROB_CACHE[key]
    # topic-tilted sampling: each sequence draws a topic that biases a slice
    # of the vocab, giving the MoE router stable structure to specialize on
    topics = rng.integers(0, data.n_topics, size=b)
    tokens = np.empty((b, s), np.int32)
    for i in range(b):
        tilt = np.ones(cfg.vocab)
        lo = (topics[i] * cfg.vocab) // data.n_topics
        hi = ((topics[i] + 1) * cfg.vocab) // data.n_topics
        tilt[lo:hi] = 4.0
        p = probs * tilt
        tokens[i] = rng.choice(cfg.vocab, size=s, p=p / p.sum())
    labels = np.roll(tokens, -1, axis=1)
    out: Dict[str, np.ndarray] = {"tokens": tokens, "labels": labels}
    if cfg.frontend == "audio":
        out = {"feats": rng.normal(0, 1, (b, s, cfg.frontend_dim))
               .astype(np.float32),
               "labels": rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
    elif cfg.frontend == "vision":
        text = s - cfg.n_patches
        out = {"tokens": tokens[:, :text],
               "labels": labels[:, :text],
               "patches": rng.normal(0, 1, (b, cfg.n_patches,
                                            cfg.frontend_dim))
               .astype(np.float32)}
    return out


def data_stream(cfg: ArchConfig, data: DataConfig, start_step: int = 0,
                shard: int = 0, n_shards: int = 1) -> Iterator[Dict]:
    step = start_step
    while True:
        yield synthetic_batch(cfg, data, step, shard, n_shards)
        step += 1
