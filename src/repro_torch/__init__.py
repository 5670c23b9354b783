"""SubStrat in PyTorch, for NVIDIA Hopper (H100).

A port of the JAX package ``repro`` (the reference, which stays as it is).
It mirrors the reference's module layout and imports nothing of it, and
nothing of JAX.  Entry points (``execute``, ``gen_dst``, ``automl_fit``,
``factorize``) take ``device=``: CUDA by default, raising if no card is
present; ``device="cpu"`` runs the same code with each hand-written
kernel's plain PyTorch version.

The TPU kernels on the main path are CUDA C++ kernels here, under
``csrc/``, built at first use (``kernels/_build.py``).
"""
from .device import make_generator, resolve_device

__all__ = ["make_generator", "resolve_device"]
