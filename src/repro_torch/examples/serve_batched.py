"""Continuous-batching serving example (the port of
``examples/serve_batched.py``): staggered requests, mixed greedy / sampled
decoding, engine throughput stats, through ``repro_torch.launch.serve``.

    python -m repro_torch.examples.serve_batched --arch internlm2-1.8b_smoke [--device cpu]
"""
import argparse

from repro_torch.launch import serve as serve_cli


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="internlm2-1.8b_smoke")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    serve_cli.main(["--arch", args.arch, "--batch", "4", "--requests", "8",
                    "--prompt-len", "32", "--gen", "16",
                    "--temperature", "0.7", "--top-k", "20", "--device", args.device])


if __name__ == "__main__":
    main()
