"""Build and load the package's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, never at import, into
``build/bigdl_tpu_torch_kernels/`` beside the package (override with
``BIGDL_TPU_TORCH_BUILD_DIR``); the library's name carries a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
loaded as it is.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "flash_attention.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_lock = threading.Lock()
_lib = None


def build_dir() -> Path:
    env = os.environ.get("BIGDL_TPU_TORCH_BUILD_DIR")
    return Path(env) if env else _PKG.parent / "build" / \
        "bigdl_tpu_torch_kernels"


def find_nvcc() -> str:
    """The CUDA compiler of the toolkit PyTorch finds (``CUDA_HOME`` /
    ``CUDA_PATH``, ``nvcc`` on PATH, or the default install)."""
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH): the "
        "bigdl_tpu_torch CUDA kernels are built from csrc/ at first use")


def nvcc_command(nvcc: str, out: Path):
    return [nvcc, *NVCC_FLAGS, "-o", str(out), *map(str, SOURCES)]


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return build_dir() / f"libbigdl_tpu_torch_kernels_{_digest()}.so"


def build() -> Path:
    """Compile the sources unless the library for their hash exists.
    The compiler's report (registers, shared memory, spills from
    ``-Xptxas=-v``) is kept in ``build.log`` beside the library."""
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    # compile to a private name, then rename: a concurrent builder never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(nvcc, Path(tmp)),
                              capture_output=True, text=True)
        (out.parent / "build.log").write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}) building "
                f"{[s.name for s in SOURCES]}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def _declare(lib):
    p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
    lib.bigdl_flash_attention.argtypes = [p, p, p, p, i, i, i, i, i, p, i,
                                          f, p]
    lib.bigdl_flash_attention.restype = i
    lib.bigdl_flash_decode_attention.argtypes = [p, p, p, p, p, i, i, i, i,
                                                 i, p, f, p]
    lib.bigdl_flash_decode_attention.restype = i
    lib.bigdl_flash_paged_decode_attention.argtypes = [
        p, p, p, p, p, p, i, i, i, i, i, i, i, i64, p, f, p]
    lib.bigdl_flash_paged_decode_attention.restype = i
    return lib


def load():
    """The loaded kernel library, building it first if needed.  Every
    launch calls this: once loaded, the handle is returned without the
    lock."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            _lib = _declare(ctypes.CDLL(str(build())))
        return _lib
