"""PyTorch/CUDA port of the trigger system in ``repro``.

The package mirrors the JAX package module for module
(``repro_torch/kernels/gravnet_block.py`` is the counterpart of
``repro/kernels/gravnet_block.py``) and imports nothing from it: what
it needs from there, it keeps a copy of. Every Pallas kernel it runs is
a CUDA C++ kernel written for Hopper (``kernels/csrc/``), with a plain
PyTorch version beside it that runs on CPU tensors.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(see :mod:`repro_torch.device`).
"""
