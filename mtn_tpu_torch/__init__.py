"""mtn_tpu_torch — the PyTorch/CUDA port of mtn_tpu for NVIDIA Hopper.

A package of its own beside ``mtn_tpu`` (the JAX reference, which it never
imports). Its layout mirrors the JAX package's:

- ``mtn_tpu_torch.config``  — the same config dataclasses and JSON schema;
- ``mtn_tpu_torch.data``    — DSTC7-AVSD vocab, dataset, features, batches;
- ``mtn_tpu_torch.ops``     — masks, positional table, attention, and the
                              hand-written Hopper kernels (``csrc/``);
- ``mtn_tpu_torch.models``  — the MTN encoder-decoder as ``nn.Module``s
                              with the flax parameter names;
- ``mtn_tpu_torch.weights`` — flax-tree bridge, init and checkpoints;
- ``mtn_tpu_torch.train``   — device batches and masks;
- ``mtn_tpu_torch.decode``  — cached beam and greedy decoding;
- ``mtn_tpu_torch.cli``     — ``python -m mtn_tpu_torch.cli.generate``.
"""

__version__ = "0.1.0"
