"""Deterministic synthetic LM data stream (per-host shardable): the
port's own copy of ``repro.data.tokens``, numpy only.

A fixed random bigram transition table with Zipfian successor weights,
so a model must learn P(next | prev) and its loss drops well below the
unigram entropy.  From the same seed and host index it yields the same
batches as the JAX package's stream, byte for byte.  The encoder
iterator comes with the hubert family (ROADMAP Queue A item 11).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 256
    seq_len: int = 128
    batch_size: int = 8
    seed: int = 1234
    branching: int = 4        # bigram successors per token
    host_index: int = 0       # per-host sharding of the stream
    host_count: int = 1


class BigramStream:
    """Zipf-weighted bigram language; deterministic given (seed, host)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        root = np.random.default_rng(cfg.seed)          # shared structure
        v, b = cfg.vocab_size, cfg.branching
        self.successors = root.integers(0, v, size=(v, b))
        probs = 1.0 / np.arange(1, b + 1)
        self.succ_probs = probs / probs.sum()
        # host-specific sampling stream
        self.rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + cfg.host_index) % (2 ** 63))

    def _sample_batch(self) -> np.ndarray:
        c = self.cfg
        out = np.empty((c.batch_size, c.seq_len + 1), np.int32)
        tok = self.rng.integers(0, c.vocab_size, size=c.batch_size)
        out[:, 0] = tok
        for t in range(1, c.seq_len + 1):
            choice = self.rng.choice(c.branching, size=c.batch_size,
                                     p=self.succ_probs)
            tok = self.successors[tok, choice]
            out[:, t] = tok
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            seqs = self._sample_batch()
            yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}


def make_lm_iterator(model_cfg: ModelConfig, batch_size: int, seq_len: int,
                     seed: int = 1234, host_index: int = 0,
                     host_count: int = 1) -> Iterator[Dict[str, np.ndarray]]:
    dc = DataConfig(vocab_size=model_cfg.vocab_size, seq_len=seq_len,
                    batch_size=batch_size, seed=seed,
                    host_index=host_index, host_count=host_count)
    return iter(BigramStream(dc))
