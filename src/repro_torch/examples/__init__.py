"""The port's counterparts of the repository's ``examples/`` scripts, each
a module with ``main(argv=None)`` that runs on the card unless
``--device cpu`` is given:

  python -m repro_torch.examples.quickstart [--device cpu]
  python -m repro_torch.examples.pretrain --arch llama-tiny --steps 40 --ckpt DIR
  python -m repro_torch.examples.finetune_compare [--pretrain-steps N --finetune-steps M]
  python -m repro_torch.examples.serve_batched --arch internlm2-1.8b_smoke

They print what the JAX scripts print, line for line in the same format.
"""
