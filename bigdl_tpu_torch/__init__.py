"""bigdl_tpu_torch: the PyTorch / CUDA port of ``bigdl_tpu`` for NVIDIA
Hopper cards.

The package keeps ``bigdl_tpu``'s module layout and parameter key names,
so a JAX checkpoint loads by key (``interop.jax_params``).  It imports
``torch``, numpy and the standard library only.  Entry points take
``device=None``, which means the CUDA card; pass ``device="cpu"`` to run
the plain PyTorch versions of the kernels on the CPU.
"""

from bigdl_tpu_torch.utils.device import resolve_device

__all__ = ["resolve_device"]
