"""Deterministic synthetic data pipeline (the port's own copy of
``repro.data.pipeline.SyntheticStream``; numpy only, same streams).

Real C4 is not available in this container, so the pipeline synthesizes a
*learnable* token stream: a noisy affine recurrence
``t_{i+1} = (a * t_i + c + e_i) mod V_eff`` with ``e_i`` uniform in
[0, noise). A model that learns the transition drives perplexity from
log(V) toward log(noise) — giving benchmarks a real signal to optimize
(used by the paper-reproduction perplexity comparisons, Fig 3a/4a/4b).

Properties a production pipeline needs and this one has:
  * deterministic per (seed, step, host_shard) — restart-safe, no state
    files required: ``state = step`` (checkpointed as one int),
  * per-host sharding: each host materializes only its slice of the global
    batch (``shard_idx/num_shards``),
  * packed fixed-length sequences with loss masks,
  * modality frontends for the stub archs: frame/patch embeddings are
    produced by a *fixed random projection* of the token stream (vlm /
    audio archs per the assignment: backbone only, frontend stubbed).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticStream:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard_idx: int = 0
    num_shards: int = 1
    noise: int = 4
    a: int = 5
    c: int = 7
    n_codebooks: int = 0        # musicgen-style multi-stream labels
    embed_dim: int = 0          # >0 => also emit 'embeds' (stub frontend)
    vision_tokens: int = 0      # >0 => also emit 'image_embeds'
    vision_dim: int = 0

    def __post_init__(self):
        if self.global_batch % self.num_shards:
            raise ValueError("num_shards must divide global_batch")
        self.local_batch = self.global_batch // self.num_shards
        self.v_eff = min(self.vocab_size, 4096)
        rng = np.random.default_rng(self.seed)
        if self.embed_dim:
            self._embed_table = rng.standard_normal(
                (self.v_eff, self.embed_dim), dtype=np.float32
            ) * 0.5

    def _tokens(self, rng, batch, length):
        t = np.empty((batch, length), np.int32)
        t[:, 0] = rng.integers(0, self.v_eff, size=batch)
        noise = rng.integers(0, self.noise, size=(batch, length)).astype(np.int64)
        for i in range(1, length):
            t[:, i] = (self.a * t[:, i - 1].astype(np.int64) + self.c + noise[:, i]) % self.v_eff
        return t

    def get_batch(self, step: int) -> dict:
        """Batch for this host at ``step`` (deterministic, stateless)."""
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + self.shard_idx
        )
        B, L = self.local_batch, self.seq_len
        out: dict = {}
        if self.n_codebooks:
            toks = np.stack(
                [self._tokens(rng, B, L + 1) for _ in range(self.n_codebooks)], axis=-1
            )  # (B, L+1, C)
            out["labels"] = toks[:, 1:, :]
            base = toks[:, :-1, 0]
        else:
            toks = self._tokens(rng, B, L + 1)
            out["labels"] = toks[:, 1:]
            base = toks[:, :-1]
        if self.embed_dim:
            out["embeds"] = self._embed_table[base]
        else:
            out["tokens"] = base
        out["mask"] = np.ones((B, L), np.float32)
        if self.vision_tokens:
            out["image_embeds"] = rng.standard_normal(
                (B, self.vision_tokens, self.vision_dim), dtype=np.float32
            )
        return out

    @classmethod
    def for_arch(cls, cfg, seq_len: int, global_batch: int, *,
                 seed: int = 0, shard_idx: int = 0, num_shards: int = 1):
        return cls(
            vocab_size=cfg.vocab_size,
            seq_len=seq_len,
            global_batch=global_batch,
            seed=seed,
            shard_idx=shard_idx,
            num_shards=num_shards,
            n_codebooks=cfg.n_codebooks,
            embed_dim=cfg.d_model if cfg.embed_inputs else 0,
            vision_tokens=cfg.vision_tokens,
            vision_dim=cfg.d_model if cfg.vision_tokens else 0,
        )
