"""PyTorch / CUDA port of qavit_tpu for one NVIDIA H100.

Imports torch and numpy only; the JAX package ``qavit_tpu`` beside it is
the reference the port is tested against.  Entry point:
``python -m qavit_tpu_torch.cli.evaluate``.
"""
