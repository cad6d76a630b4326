#!/usr/bin/env python3
"""Wall time of building the PyTorch port's CUDA kernels from nothing:
``_build.build()`` (one ``nvcc`` per source in ``csrc/``, all started
together) against one ``nvcc`` over all the sources into one library,
with the same flags.  Each build goes into a fresh directory under
``build/``, in the order one, parallel, parallel, one.

    python3 tools/torch_build_time.py

Prints one JSON line per build and a summary line.  Needs ``nvcc``.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from bigdl_tpu_torch.ops import _build  # noqa: E402


def one_nvcc(out_dir: Path):
    nvcc = _build.find_nvcc()
    cmd = [nvcc, *_build.NVCC_FLAGS, "-o", str(out_dir / "all.so"),
           *map(str, _build.SOURCES)]
    subprocess.run(cmd, check=True, capture_output=True)


def parallel(out_dir: Path):
    os.environ["BIGDL_TPU_TORCH_BUILD_DIR"] = str(out_dir)
    _build.build()


def main():
    (ROOT / "build").mkdir(exist_ok=True)
    times = {"one_nvcc": [], "parallel": []}
    for label in ("one_nvcc", "parallel", "parallel", "one_nvcc"):
        out_dir = Path(tempfile.mkdtemp(prefix="build_time_",
                                        dir=ROOT / "build"))
        try:
            t0 = time.perf_counter()
            (one_nvcc if label == "one_nvcc" else parallel)(out_dir)
            seconds = time.perf_counter() - t0
        finally:
            shutil.rmtree(out_dir)
        times[label].append(seconds)
        print(json.dumps({"build": label, "seconds": seconds,
                          "sources": len(_build.SOURCES),
                          "cpus": os.cpu_count()}), flush=True)
    print(json.dumps({"summary": times,
                      "one_over_parallel": sum(times["one_nvcc"]) /
                      sum(times["parallel"])}), flush=True)


if __name__ == "__main__":
    main()
