"""Serving entry points of the port (``repro/train/serve_step.py``):
prefill, the single-token decode step and greedy generation.

``greedy_decode`` rides the serving engine's decode loop
(serve/engine.py): the generation runs as decode blocks that keep the slot
vectors on the device and synchronise with the host once per block.
``greedy_decode_per_token`` is the per-token Python loop over
``decode_step`` that the engine's block replaced: the baseline it is
compared against. A vision arch's batch carries ``image_embeds`` (B,
vision_tokens, d), handed to each request (or to the batched prefill).
``make_prefill`` / ``make_decode_step`` take an embed-input arch's
embeddings (musicgen: ``embeds`` in the batch, (B, L, d) for a step);
both greedy loops refuse it, as the JAX package's do: an argmax over its
logits is no next input.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models import decode_step as _decode
from repro_torch.models import prefill as _prefill
from repro_torch.serve import Request, ServeEngine

def _require_token_frontend(cfg) -> None:
    if cfg.embed_inputs:
        raise NotImplementedError("greedy loop needs a token frontend")


def make_prefill(cfg, rcfg, *, max_len: int):
    def prefill_fn(model, batch):
        return _prefill(cfg, rcfg, model, batch, max_len)

    return prefill_fn


def make_decode_step(cfg, rcfg):
    def step_fn(model, tokens, pos, caches):
        return _decode(cfg, rcfg, model, tokens, pos, caches)

    return step_fn


def greedy_decode(cfg, rcfg, model, batch, *, steps: int, max_len: int) -> torch.Tensor:
    """Batched greedy generation through the serving engine.

    One request per batch row, all admitted at once; returns (B, steps)
    int64 on the model's device -- the per-token loop's tokens."""
    _require_token_frontend(cfg)
    tokens = np.asarray(torch.as_tensor(batch["tokens"]).cpu())
    B = tokens.shape[0]
    # token 0 comes from the prefill logits, so the blocks decode steps - 1
    engine = ServeEngine(cfg, rcfg, model, max_slots=B, max_len=max_len,
                         decode_block=max(1, steps - 1))
    images = (np.asarray(torch.as_tensor(batch["image_embeds"]).float().cpu())
              if cfg.vision_tokens else [None] * B)
    results = engine.run([Request(uid=i, tokens=tokens[i].tolist(), max_new_tokens=steps,
                                  image_embeds=images[i]) for i in range(B)])
    return torch.tensor(np.stack([results[i].tokens for i in range(B)]),
                        dtype=torch.int64, device=model.device)


def greedy_decode_per_token(cfg, rcfg, model, batch, *, steps: int,
                            max_len: int) -> torch.Tensor:
    """The per-token Python loop (the baseline the engine's block is
    measured against): one batched prefill, then ``decode_step`` and an
    argmax per token. Returns (B, steps) int64 on the model's device."""
    _require_token_frontend(cfg)
    tokens = torch.as_tensor(batch["tokens"], device=model.device).long()
    pbatch = {"tokens": tokens}
    if cfg.vision_tokens:
        pbatch["image_embeds"] = torch.as_tensor(batch["image_embeds"], device=model.device)
    logits, caches = _prefill(cfg, rcfg, model, pbatch, max_len)
    B, prompt_len = tokens.shape
    step_fn = make_decode_step(cfg, rcfg)
    tok = logits[:, -1, : cfg.vocab_size].argmax(dim=-1)[:, None]
    out = [tok]
    for i in range(steps - 1):
        pos = torch.full((B, 1), prompt_len + i, dtype=torch.int32, device=model.device)
        logits, caches = step_fn(model, tok, pos, caches)
        tok = logits[:, :, : cfg.vocab_size].argmax(dim=-1)
        out.append(tok)
    return torch.cat(out, dim=1)
