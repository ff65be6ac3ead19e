"""Deterministic, stateless data pipeline.

A copy of ``repro.data.pipeline`` (numpy and Philox only, so that
``batch_for_step`` is bitwise the reference's for every kind and a token
file), except :func:`make_pipeline`, which takes the rank and world size
from ``torch.distributed`` when a process group is up, else 0 and 1.

``batch_for_step(step)`` is a pure function of (seed, step, shard) via a
counter-based Philox generator, so checkpoint/restart recovery replays the
exact token stream with zero pipeline state, and each host reads only its
shard.  A memory-mapped binary token-file source covers real-corpus
training.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    kind: str = "tokens"      # tokens | embeds | frames
    d_model: int = 0          # for embeds/frames
    token_file: str = ""      # optional memmap source


def _rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    key = np.array([np.uint64(cfg.seed) ^ (np.uint64(shard) << np.uint64(32)),
                    np.uint64(step)], np.uint64)
    return np.random.Generator(np.random.Philox(key=key))


class Pipeline:
    """num_shards = number of data hosts; this instance yields shard ``shard``."""

    def __init__(self, cfg: DataConfig, shard: int = 0, num_shards: int = 1):
        assert cfg.global_batch % num_shards == 0
        self.cfg = cfg
        self.shard = shard
        self.num_shards = num_shards
        self.local_batch = cfg.global_batch // num_shards
        self._mm = None
        if cfg.token_file:
            self._mm = np.memmap(cfg.token_file, dtype=np.uint32, mode="r")

    def batch_for_step(self, step: int) -> dict:
        cfg = self.cfg
        g = _rng(cfg, step, self.shard)
        b, s = self.local_batch, cfg.seq_len
        if cfg.kind == "embeds":
            return {"embeds": g.standard_normal((b, s, cfg.d_model),
                                                dtype=np.float32),
                    "labels": g.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
        if cfg.kind == "frames":
            return {"frames": g.standard_normal((b, s, cfg.d_model),
                                                dtype=np.float32),
                    "tokens": g.integers(0, cfg.vocab, (b, s)).astype(np.int32)}
        if self._mm is not None:
            n = len(self._mm) - s - 1
            starts = g.integers(0, n, (b,))
            toks = np.stack([self._mm[i:i + s] for i in starts])
            return {"tokens": (toks % cfg.vocab).astype(np.int32)}
        return {"tokens": g.integers(0, cfg.vocab, (b, s)).astype(np.int32)}


def write_token_file(path: str, tokens: np.ndarray) -> None:
    tokens.astype(np.uint32).tofile(path)


def make_pipeline(cfg: DataConfig, process_index: int | None = None,
                  process_count: int | None = None) -> Pipeline:
    up = dist.is_available() and dist.is_initialized()
    pi = (dist.get_rank() if up else 0) if process_index is None else process_index
    pc = (dist.get_world_size() if up else 1) if process_count is None else process_count
    return Pipeline(cfg, shard=pi, num_shards=pc)
