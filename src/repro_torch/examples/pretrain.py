"""End-to-end pretraining script (the port of ``examples/pretrain.py``):
trains a LLaMA-family model with PAMM on the synthetic C4-like stream
through the port's training entry point, ``repro_torch.launch.train`` --
the checkpoint/restart supervisor (``--ckpt``: a checkpoint every 100
steps and at the end, resuming from the latest), the straggler watchdog,
warmup + cosine schedule, per-group PAMM LR scaling.

    python -m repro_torch.examples.pretrain --arch llama-60m --steps 300 \
        --seq-len 256 --global-batch 8 --ckpt /tmp/pamm_ckpt

CI-scale smoke:

    python -m repro_torch.examples.pretrain --arch llama-tiny --steps 40 --device cpu
"""
import argparse

from repro_torch.launch import train as train_cli

RATIO = 512                 # PAMM at r = 1/512 (the CLI's legacy --policy pamm)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama-tiny")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    argv = [
        "--arch", args.arch, "--steps", str(args.steps),
        "--seq-len", str(args.seq_len), "--global-batch", str(args.global_batch),
        "--policy", "pamm", "--ratio", str(RATIO), "--log-every", "20",
        "--device", args.device,
    ]
    if args.ckpt:
        argv += ["--ckpt-dir", args.ckpt, "--ckpt-every", "100"]
    train_cli.main(argv)


if __name__ == "__main__":
    main()
