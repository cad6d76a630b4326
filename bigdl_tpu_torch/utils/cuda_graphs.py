"""CUDA graph capture shared by the built generation steps
(``serving/graphs.py``) and the compiled training step
(``optim/graphs.py``): the port's counterpart of compiling a function
once per shape with ``jax.jit``.

A ``Capturer`` owns one graph pool and one capture stream on a device.
``warm_up(fn)`` runs a step eagerly on that stream, where the kernels'
libraries, cuBLAS's workspace and the allocator's blocks for the stream
come into being (a capture may not make them); ``capture(fn)`` records
one run of it as a graph in the pool.  The kernel wrappers count their
launches in Python, which a replay does not run: a capture records the
launches issued to the capture stream, from any thread
(``ops.flash_attention.deferred_launch_counts``), and ``replay`` adds
that record every time.  A warm-up's launches are recorded apart, in
``warmup_launches``, so the counts of a run are those of its steps.
``free_cached()`` releases the allocator's cached blocks to the device
before a capture that needs the room (the training step's, after its
eager warm-up), as ``torch.cuda.graph`` does before every capture.
A capture that raises leaves no graph behind and propagates: nothing
runs eagerly in its place.
"""

import gc
import threading

import torch

from bigdl_tpu_torch.ops import flash_attention as fa

#: eager runs of a step on the capture stream before it is captured
WARMUP_RUNS = 2

_captures = 0
_captures_lock = threading.Lock()


def capture_count() -> int:
    """Steps built in this process, generation and training (on the card:
    CUDA graphs captured), the counterpart of JAX's
    ``backend_compile_count``."""
    return _captures


def note_capture():
    global _captures
    with _captures_lock:
        _captures += 1


class Capturer:
    """One graph pool and capture stream on a CUDA ``device``."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        #: launches of every warm-up run, ``{table: {kernel: n}}``
        self.warmup_launches = {}

    def warm_up(self, fn, runs=WARMUP_RUNS):
        """Run ``fn()`` ``runs`` times on the capture stream, after the
        current stream's work, and wait for them."""
        side = self.stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side), fa.deferred_launch_counts() as rec:
            for _ in range(runs):
                fn()
        side.synchronize()
        fa.add_launch_counts(rec, into=self.warmup_launches)

    def free_cached(self):
        """Release the cached, unused blocks to the device: the pool takes
        fresh device memory while capturing, where the allocator may not
        free cached blocks to make room."""
        self.stream.synchronize()
        gc.collect()
        torch.cuda.empty_cache()

    def capture(self, fn):
        """Capture one run of ``fn()`` on the capture stream: returns
        ``(graph, fn's outputs, launch record)``.  Every kernel ``fn``
        issues, the backward's too, must go to the current stream."""
        side = self.stream
        side.wait_stream(torch.cuda.current_stream(self.device))
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.stream(side), fa.deferred_launch_counts() as rec:
            graph.capture_begin(pool=self.pool,
                                capture_error_mode="thread_local")
            try:
                outputs = fn()
            except BaseException:
                self._abandon(graph)
                raise
            graph.capture_end()
        torch.cuda.current_stream(self.device).wait_stream(side)
        note_capture()
        return graph, outputs, rec

    def _abandon(self, graph):
        """End a capture whose step raised; the step's error propagates.
        An invalidated capture's ``capture_end`` can raise before the
        allocator stops routing the pool to it, and the allocator then
        refuses every later capture into that pool: the routing is ended
        here and later captures take a fresh pool."""
        try:
            graph.capture_end()
        except Exception:
            pass
        index = self.device.index if self.device.index is not None \
            else torch.cuda.current_device()
        try:
            torch._C._cuda_endAllocateToPool(index, self.pool)
        except Exception:
            pass                    # capture_end had ended it
        self.pool = torch.cuda.graph_pool_handle()

    @staticmethod
    def replay(graph, launches):
        """Launch ``graph`` on the current stream and count the launches
        its capture recorded."""
        graph.replay()
        fa.add_launch_counts(launches)
