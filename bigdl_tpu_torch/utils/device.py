"""Device resolution for every entry point of the port."""

import warnings

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card, which must be present; the CPU is
    used only when the caller asks for it (``device="cpu"``).  On a CUDA
    device the matrix products are held to full fp32
    (``require_fp32_matmul``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "bigdl_tpu_torch runs on a CUDA card and none is available; "
                "pass device='cpu' to run the plain PyTorch path on the CPU")
        require_fp32_matmul()
    return dev


def require_fp32_matmul():
    """The port computes in fp32, as the JAX reference does, so TF32
    matrix products (``torch.set_float32_matmul_precision("high")`` or
    ``torch.backends.cuda.matmul.allow_tf32 = True``) and TF32 cuDNN
    convolutions (``torch.backends.cudnn.allow_tf32``, which PyTorch
    turns on by default) are switched off, with a warning when either was
    on."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        warnings.warn("bigdl_tpu_torch computes in fp32: TF32 matrix "
                      "products and convolutions switched off",
                      RuntimeWarning, stacklevel=3)
        torch.set_float32_matmul_precision("highest")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def same_device(a: torch.device, b: torch.device) -> bool:
    """``cuda`` and ``cuda:<current>`` name the same device."""
    def full(d):
        if d.type == "cuda" and d.index is None:
            return torch.device("cuda", torch.cuda.current_device())
        return d
    return full(torch.device(a)) == full(torch.device(b))
