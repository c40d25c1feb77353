"""Deterministic, shardable data pipeline.

Batches are a pure function of (seed, step) — ``batch_at(step)`` — so:

  * restart/elastic-rescale resumes mid-epoch exactly (the checkpoint
    stores only the step counter);
  * any data-parallel worker can regenerate any shard (straggler
    reassignment never loses data);
  * no host-side state needs checkpointing.

Two sources: a synthetic Zipf-distributed LM stream (default), and a
binary token-file source (memory-mapped) for file-backed corpora. Both
emit {tokens, labels} with next-token labels, plus the stub frontend
embeddings for vlm/audio archs.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    zipf_a: float = 1.2         # synthetic token distribution


class SyntheticLM:
    """Zipf-token synthetic LM stream with learnable bigram structure
    (token t+1 depends on t through a fixed permutation mix), so training
    loss actually decreases — useful for end-to-end example runs."""

    def __init__(self, cfg: ArchConfig, batch: int, seq_len: int,
                 data_cfg: DataConfig = DataConfig()):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.dc = data_cfg
        rng = np.random.default_rng(data_cfg.seed + 1234)
        self._perm = rng.permutation(cfg.vocab)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.dc.seed, step]))
        b, s, v = self.batch, self.seq_len, self.cfg.vocab
        # Zipf marginals, clipped to vocab.
        base = rng.zipf(self.dc.zipf_a, size=(b, s + 1))
        toks = np.minimum(base - 1, v - 1).astype(np.int32)
        # Inject bigram structure: with p=0.5 the next token is a fixed
        # function of the current one.
        follow = self._perm[toks[:, :-1]]
        use = rng.random((b, s)) < 0.5
        nxt = np.where(use, follow, toks[:, 1:])
        seq = np.concatenate([toks[:, :1], nxt], axis=1)
        out = {"tokens": seq[:, :-1].astype(np.int32),
               "labels": seq[:, 1:].astype(np.int32)}
        if self.cfg.family in ("vlm", "audio"):
            out["frontend"] = rng.standard_normal(
                (b, self.cfg.frontend_len, self.cfg.d_model),
                dtype=np.float32) * 0.02
        return out


class TokenFileSource:
    """Memory-mapped flat token file (uint16/uint32), deterministic
    window sampling by step."""

    def __init__(self, cfg: ArchConfig, path: str, batch: int, seq_len: int,
                 dtype=np.uint16, seed: int = 0):
        self.cfg = cfg
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        n = len(self.tokens) - self.seq_len - 1
        starts = rng.integers(0, n, size=self.batch)
        rows = np.stack([self.tokens[s:s + self.seq_len + 1]
                         for s in starts]).astype(np.int32)
        rows = np.minimum(rows, self.cfg.vocab - 1)
        return {"tokens": rows[:, :-1], "labels": rows[:, 1:]}


def make_source(cfg: ArchConfig, batch: int, seq_len: int,
                path: Optional[str] = None, seed: int = 0):
    if path:
        return TokenFileSource(cfg, path, batch, seq_len, seed=seed)
    return SyntheticLM(cfg, batch, seq_len, DataConfig(seed=seed))
