"""dragonboat_tpu_torch: the batched quorum engine of dragonboat_tpu on
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper.

Counterpart: the ``dragonboat_tpu`` package, which stays the reference.
This package imports nothing of it and nothing of JAX.  Its entry points
run on a CUDA device unless the caller passes ``device="cpu"``, where the
plain PyTorch versions of the kernels run instead.
"""
from .platform import pick_device  # noqa: F401

__version__ = "0.1.0"
