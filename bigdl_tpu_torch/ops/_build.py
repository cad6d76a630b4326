"""Build and load the package's CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library of its own with a plain C interface, loaded with
``ctypes``; the compilers for all sources run at once.  The build runs
at first use, never at import, into ``build/bigdl_tpu_torch_kernels/``
beside the package (override with ``BIGDL_TPU_TORCH_BUILD_DIR``); each
library's name carries a hash of its source, the shared headers and the
flags, so an edited source rebuilds and an unchanged one is loaded as
it is.
"""

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
import types
from concurrent.futures import ThreadPoolExecutor
from functools import partial
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
SOURCES = (CSRC / "flash_attention.cu", CSRC / "flash_attention_bwd.cu",
           CSRC / "cross_entropy.cu", CSRC / "int8_conv.cu",
           CSRC / "act_quant.cu", CSRC / "bn_act.cu")
HEADERS = (CSRC / "common.cuh", CSRC / "mma.cuh", CSRC / "wgmma.cuh")
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


def nvcc_command(nvcc: str, out: Path, source: Path):
    return [nvcc, *NVCC_FLAGS, "-o", str(out), str(source)]


def _digest(source: Path) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (source, *HEADERS):
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path(source: Path) -> Path:
    return build_dir() / f"lib{source.stem}_{_digest(source)}.so"


def _compile(nvcc: str, source: Path) -> Path:
    """Compile one source unless the library for its hash exists.  The
    compiler's report (registers, shared memory, spills from
    ``-Xptxas=-v``) is kept in ``<stem>.build.log`` beside the library."""
    out = library_path(source)
    if out.exists():
        return out
    # compile to a private name, then rename: a concurrent builder never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        proc = subprocess.run(nvcc_command(nvcc, Path(tmp), source),
                              capture_output=True, text=True)
        (out.parent / f"{source.stem}.build.log").write_text(proc.stdout +
                                                             proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}) building "
                               f"{source.name}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return out


def build():
    """Compile every source whose library does not exist yet, one
    ``nvcc`` per source, all started together (``tools/torch_build_time.py``
    times this against one ``nvcc`` over all sources).  Returns the
    library paths, in the order of ``SOURCES``."""
    outs = [library_path(src) for src in SOURCES]
    if all(out.exists() for out in outs):
        return outs
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        return list(pool.map(partial(_compile, nvcc), SOURCES))


def build_logs():
    """The compilers' reports of the last build, by source stem."""
    return {src.stem: (build_dir() / f"{src.stem}.build.log").read_text()
            for src in SOURCES
            if (build_dir() / f"{src.stem}.build.log").exists()}


def _declare(libs):
    """One namespace holding every entry point of the libraries, each
    with its argument and return types."""
    p, i, i64, f = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                    ctypes.c_float)
    signatures = {
        "bigdl_flash_attention": [p, p, p, p, i, i, i, i, i, p, i, f, p, p],
        "bigdl_flash_decode_attention": [p, p, p, p, p, i, i, i, i, i, p, f,
                                         i, p],
        "bigdl_flash_paged_decode_attention": [
            p, p, p, p, p, p, i, i, i, i, i, i, i, i64, p, f, i, p],
        "bigdl_flash_paged_decode_attention_int8": [
            p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i64, p, f, i, p],
        "bigdl_empty_cluster_launch": [i, i, p],
        "bigdl_flash_attention_bwd": [p, p, p, p, p, p, p, p, p, p, i, i, i,
                                      i, i, p, i, f, p],
        "bigdl_ce_fwd": [p, p, p, p, i, i, i, i64, p],
        "bigdl_ce_fwd_shard": [p, p, p, p, p, i, i, i, i64, p],
        "bigdl_ce_bwd": [p, p, p, p, p, i, i, i, i64, i64, p],
        "bigdl_int8_conv": [p, p, p, p, p, p] + [i] * 17 + [p],
        "bigdl_int8_conv_wgmma": [p, p, i, i, p, p, p, p] + [i] * 17 + [p],
        "bigdl_act_quant": [p, i64, i, p, p, p, i, p],
        "bigdl_act_quant_given": [p, i64, i, p, p, p, i, p],
        "bigdl_act_quant_small": [p, i64, i, p, p, i, p],
        "bigdl_bn_act": [p, p, p, i64, i, i, p, p, p, p, f, p, p, p, p, f, i,
                         p, i, p],
    }
    ns = types.SimpleNamespace()
    for name, argtypes in signatures.items():
        fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
        fn.argtypes = argtypes
        fn.restype = i
        setattr(ns, name, fn)
    return ns


def load():
    """The loaded kernel entry points, building the libraries first if
    needed.  Every launch calls this: once loaded, the namespace is
    returned without the lock."""
    global _lib
    lib = _lib
    if lib is not None:
        return lib
    with _lock:
        if _lib is None:
            _lib = _declare([ctypes.CDLL(str(path)) for path in build()])
        return _lib
