#!/usr/bin/env python3
"""How far bf16 decode logits drift from the full forward's with depth, at
musicgen-medium's width, on the CPU through the kernels' plain versions:
the basis of chip_smoke.py's TOL_AUDIO_DECODE. For each depth, musicgen-
medium cut to that many layers (bf16, random weights from seed 0) runs a
prefill over ``--prompt`` stream embeddings of 2 rows and 4 decode steps,
each fed the next embedding; each step's logits are held against the full
forward's at the same position. Prints, per depth, the worst |diff| of a
row's largest |logit|. Run from the repository root:

  python3 tools/audio_drift.py [--layers 2 8 24] [--prompt 128]
"""
import argparse
import dataclasses
import os
import sys

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src")))

import torch  # noqa: E402

from repro_torch.configs import RunConfig, get_config  # noqa: E402
from repro_torch.core.keys import Key  # noqa: E402
from repro_torch.data import SyntheticStream  # noqa: E402
from repro_torch.models import decode_step, forward, init_model, prefill  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--layers", type=int, nargs="+", default=[2, 8, 24])
ap.add_argument("--prompt", type=int, default=128)
args = ap.parse_args()
B, L, n = 2, args.prompt, 4
rcfg = RunConfig(compute_dtype="bfloat16", param_dtype="bfloat16", policy_name="none")
for layers in args.layers:
    cfg = dataclasses.replace(get_config("musicgen-medium"), n_layers=layers,
                              stages=((("attn",), layers),))
    model = init_model(cfg, rcfg, seed=0, device="cpu")
    e = torch.from_numpy(SyntheticStream.for_arch(cfg, L + n, B).get_batch(0)["embeds"])
    with torch.no_grad():
        h, _ = forward(cfg, rcfg, "", model, {"embeds": e}, Key(0))
        full = (h[:, L - 1:] @ model.head.to(h.dtype)).float()
    logits, caches = prefill(cfg, rcfg, model, {"embeds": e[:, :L]}, L + n)
    got = [logits]
    for i in range(n):
        pos = torch.full((B, 1), L + i, dtype=torch.int32)
        logits, caches = decode_step(cfg, rcfg, model, e[:, L + i:L + i + 1], pos, caches)
        got.append(logits)
    rel = [((g[:, 0] - full[:, i]).abs().amax(-1) / full[:, i].abs().amax(-1)).max().item()
           for i, g in enumerate(got)]
    print(f"{layers} layers, prompt {L}: worst |decode - full forward| of the row's max "
          f"|logit| {max(rel):.3e} (prefill {rel[0]:.3e}; steps "
          f"{', '.join(f'{r:.3e}' for r in rel[1:])})", flush=True)
