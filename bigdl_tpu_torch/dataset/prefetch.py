"""Asynchronous input pipeline: background transform workers and a
bounded queue (the port's copy of ``bigdl_tpu/dataset/prefetch.py``:
host threads only, no device work; the optimizer's pinned copy moves
each batch to the card).

``PrefetchDataSet`` wraps any ``AbstractDataSet`` (``>>`` chains
included) and runs its transformer chain on background threads:

    producer ---> work queue ---> N workers (per-element stages)
                                      |
                              reorder-by-sequence
                                      |
                  assembler (order-dependent stages, e.g. SampleToMiniBatch)
                                      |
                        bounded output queue ---> training loop

Determinism: workers run only stages that declare ``apply_one``
(element-wise, no state across elements: ``FnTransformer``,
``Normalizer``); their outputs are put back in source order before the
remaining stages run serially, so the batch sequence is the synchronous
path's for a fixed seed.  Epoch reshuffles keep that: the driver loop
makes a new iterator each epoch, and ``shuffle()`` / ``data()`` retire
the previous epoch's threads first.

Memory is bounded: ``queue_depth`` ready batches plus a reorder window
of elements in flight; workers that run ahead of the consumer wait.
``shutdown()`` (called when ``optimize()`` returns or raises) stops and
joins every thread; a producer blocked inside a stream source's
uninterruptible ``next()`` is left as a daemon instead of stalling it.
"""

import logging
import queue
import threading
from typing import Iterator, List, Optional, Tuple

from bigdl_tpu_torch.dataset.dataset import (AbstractDataSet,
                                             TransformedDataSet)
from bigdl_tpu_torch.dataset.transformer import (ChainedTransformer,
                                                 Transformer)

log = logging.getLogger("bigdl_tpu_torch.dataset")

#: end-of-stream marker on the internal queues (never yielded to callers)
_DONE = object()

#: worker threads check the stop flag at this cadence while blocked
_POLL_S = 0.05


def _flatten_chain(transformer: Transformer) -> List[Transformer]:
    if isinstance(transformer, ChainedTransformer):
        return (_flatten_chain(transformer.first)
                + _flatten_chain(transformer.second))
    return [transformer]


def decompose(dataset: AbstractDataSet) -> Tuple[AbstractDataSet,
                                                 List[Transformer]]:
    """Walk nested ``TransformedDataSet`` wrappers -> (source, stages in
    application order), flattening ``ChainedTransformer`` compositions."""
    stages: List[Transformer] = []
    while isinstance(dataset, TransformedDataSet):
        stages = _flatten_chain(dataset.transformer) + stages
        dataset = dataset.base
    return dataset, stages


def split_parallel(stages: List[Transformer]):
    """Split the chain at the first order-dependent stage: the prefix of
    ``apply_one`` stages fans out across workers; the suffix (batching,
    stages opting out via ``parallel_safe=False``) runs serially on the
    reordered stream."""
    fns = []
    for i, t in enumerate(stages):
        fn = getattr(t, "apply_one", None)
        if not callable(fn):
            return fns, stages[i:]
        fns.append(fn)
    return fns, []


class _PrefetchIterator:
    """One epoch-stream's worth of pipeline threads.

    Threads: 1 producer (pulls the source iterator -- the ONLY consumer of
    the underlying data order), ``num_workers`` transform workers, and 1
    assembler that restores source order and applies the serial suffix
    stages into the bounded output queue.  All are daemons named
    ``bigdl-prefetch-*`` and stop-flag aware, so ``close()`` converges in
    ~``_POLL_S`` even with full queues; the first exception from any
    thread is re-raised in the consumer's ``next()`` (never a silent
    hang).
    """

    def __init__(self, source_iter: Iterator, per_element, suffix,
                 num_workers: int, queue_depth: int):
        self._source_iter = source_iter
        self._per_element = list(per_element)
        self._suffix = list(suffix)
        self._num_workers = num_workers
        self._work_q = queue.Queue(maxsize=max(2 * num_workers, queue_depth))
        self._out = queue.Queue(maxsize=queue_depth)
        self._ready = {}              # seq -> transformed element
        #: reorder window: a worker holding seq >= _next_seq + _window
        #: waits before depositing, so when the consumer stalls the
        #: pipeline stops at (window + workers + queue_depth) buffered
        #: elements instead of freewheeling the source into host memory.
        #: FIFO task pickup means the waiters always hold the HIGHEST
        #: outstanding seqs, so _next_seq can always advance (no deadlock)
        self._window = self._work_q.maxsize
        self._next_seq = 0
        self._cond = threading.Condition()
        self._n_items: Optional[int] = None   # set when the source ends
        self._stop = threading.Event()
        #: producer is inside the source's (uninterruptible) next()
        self._reading = threading.Event()
        self._err: Optional[BaseException] = None
        self._threads = [
            threading.Thread(target=self._produce,
                             name="bigdl-prefetch-producer", daemon=True)]
        self._threads += [
            threading.Thread(target=self._work,
                             name=f"bigdl-prefetch-worker-{i}", daemon=True)
            for i in range(num_workers)]
        self._threads.append(
            threading.Thread(target=self._assemble,
                             name="bigdl-prefetch-assembler", daemon=True))
        for t in self._threads:
            t.start()

    # ----- thread bodies --------------------------------------------------- #
    def _put(self, q, item) -> bool:
        """Stop-aware blocking put; False when shut down mid-wait."""
        while not self._stop.is_set():
            try:
                q.put(item, timeout=_POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _fail(self, exc: BaseException):
        with self._cond:
            if self._err is None:
                self._err = exc
            self._stop.set()
            self._cond.notify_all()
        try:                          # wake a consumer blocked on get()
            self._out.put_nowait(_DONE)
        except queue.Full:
            pass

    def _produce(self):
        seq = 0
        try:
            while not self._stop.is_set():
                # the source read cannot be interrupted; flag it so
                # close() knows not to wait on a blocked stream source
                self._reading.set()
                try:
                    item = next(self._source_iter)
                except StopIteration:
                    break
                finally:
                    self._reading.clear()
                if not self._put(self._work_q, (seq, item)):
                    return
                seq += 1
            else:
                return                # shut down mid-stream
        except Exception as e:
            self._fail(e)
            return
        with self._cond:              # finite source exhausted (eval path)
            self._n_items = seq
            self._cond.notify_all()
        for _ in range(self._num_workers):
            if not self._put(self._work_q, _DONE):
                return

    def _work(self):
        while not self._stop.is_set():
            try:
                task = self._work_q.get(timeout=_POLL_S)
            except queue.Empty:
                continue
            if task is _DONE:
                return
            seq, item = task
            try:
                for fn in self._per_element:
                    item = fn(item)
            except Exception as e:
                self._fail(e)
                return
            with self._cond:
                # backpressure: far-ahead results wait for the consumer
                # (bounds the reorder buffer; see _window above)
                while (not self._stop.is_set()
                       and seq - self._next_seq >= self._window):
                    self._cond.wait(timeout=_POLL_S)
                if self._stop.is_set():
                    return
                self._ready[seq] = item
                self._cond.notify_all()

    def _ordered(self):
        """Yield worker outputs in SOURCE order (the determinism seam)."""
        while True:
            with self._cond:
                nxt = self._next_seq
                while True:
                    if self._stop.is_set():
                        return
                    if nxt in self._ready:
                        item = self._ready.pop(nxt)
                        self._next_seq = nxt + 1
                        self._cond.notify_all()   # wake waiting workers
                        break
                    if self._n_items is not None and nxt >= self._n_items:
                        return
                    self._cond.wait(timeout=_POLL_S)
            yield item

    def _assemble(self):
        try:
            stream = self._ordered()
            for t in self._suffix:
                stream = t.apply(stream)
            for item in stream:
                if not self._put(self._out, item):
                    return
        except Exception as e:
            self._fail(e)
            return
        self._put(self._out, _DONE)

    # ----- consumer side --------------------------------------------------- #
    def __iter__(self):
        return self

    def __next__(self):
        while True:
            if self._err is not None:
                err = self._err
                self.close()
                raise err
            try:
                item = self._out.get(timeout=_POLL_S)
            except queue.Empty:
                if self._stop.is_set() and self._err is None:
                    raise StopIteration
                continue
            if item is _DONE:
                if self._err is not None:
                    continue          # error sentinel: raise on next pass
                raise StopIteration
            return item

    def depth(self) -> int:
        """Current output-queue occupancy (0 = the training loop is about
        to block on the producers: a starved pipeline)."""
        return self._out.qsize()

    def close(self):
        """Stop and join every pipeline thread (drain semantics: queued
        items are discarded; the source iterator is simply abandoned).

        A producer blocked inside a stream source's ``next()`` cannot be
        interrupted from Python: it is left behind as a daemon (it dies
        with the process, or exits the moment the source yields) instead
        of stalling shutdown -- sources with an indefinitely-blocking
        read should arrange their own end-of-stream signal."""
        self._stop.set()
        with self._cond:
            self._cond.notify_all()
        for t in self._threads:
            if t is threading.current_thread():
                continue
            blocked_in_source = (t.name == "bigdl-prefetch-producer"
                                 and self._reading.is_set())
            t.join(timeout=0.2 if blocked_in_source else 5.0)
        alive = [t.name for t in self._threads
                 if t.is_alive() and t is not threading.current_thread()]
        if alive and self._reading.is_set() and \
                alive == ["bigdl-prefetch-producer"]:
            log.debug("prefetch producer left blocked in the source's "
                      "next(); daemon thread will exit with the source")
        elif alive:                   # pragma: no cover - defensive
            log.warning("prefetch threads failed to join: %s", alive)
        self._threads = []

    def __del__(self):                # pragma: no cover - GC backstop
        try:
            self._stop.set()
        except Exception:
            pass


class PrefetchDataSet(AbstractDataSet):
    """Run a dataset's transformer chain in background worker threads
    feeding a bounded queue, overlapping host-side input work with device
    compute.

        train = (array_dataset(x, y) >> Normalizer(m, s)
                 >> SampleToMiniBatch(128)).prefetch(num_workers=4)

    ``num_workers`` bounds transform parallelism (0 = fully synchronous
    passthrough, for A/B); ``queue_depth`` bounds ready batches held ahead
    of the training loop (host memory = queue_depth batches).  Training
    iterators (``data(train=True)``) are asynchronous; the evaluation
    stream (``train=False``) stays synchronous -- validation cadence is
    bursty and correctness-critical, and the serial path is trivially
    ordered and leak-free.

    One live training stream at a time: ``shuffle()`` / ``data(train=True)``
    retire the previous epoch's threads first (the driver loop re-creates
    the iterator each epoch), and ``shutdown()`` -- called by the driver
    loop when training ends, including the PREDICTED_END early-stop path --
    joins everything so no thread outlives the run.
    """

    def __init__(self, base: AbstractDataSet, num_workers: int = 2,
                 queue_depth: int = 4):
        if num_workers < 0:
            raise ValueError(f"num_workers must be >= 0, got {num_workers}")
        if queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1, got {queue_depth}")
        self.base = base
        self.num_workers = num_workers
        self.queue_depth = queue_depth
        self._live: Optional[_PrefetchIterator] = None

    def size(self) -> int:
        return self.base.size()

    def shuffle(self):
        # retire in-flight workers BEFORE the index mutates: discarded
        # prefetched elements belong to the pre-shuffle order, exactly the
        # elements the synchronous path never materialised
        self.shutdown()
        self.base.shuffle()

    def data(self, train: bool):
        if not train:
            return self.base.data(train=False)
        self.shutdown()
        if self.num_workers == 0:
            return self.base.data(train=True)
        source, stages = decompose(self.base)
        per_element, suffix = split_parallel(stages)
        self._live = _PrefetchIterator(
            source.data(train=True), per_element, suffix,
            self.num_workers, self.queue_depth)
        return self._live

    def shutdown(self):
        """Stop and join the live pipeline threads (idempotent)."""
        if self._live is not None:
            self._live.close()
            self._live = None

    def position_state(self):
        """Delegates to the source: the pipeline itself holds no order
        state -- workers fan out but the reorder stage + serial suffix
        (SampleToMiniBatch) keep the BATCH stream identical to the
        synchronous path, so "k batches consumed" pins the same source
        position either way (the optimizer's mid-epoch resume)."""
        return self.base.position_state()

    def restore_position(self, state):
        # retire in-flight workers first: buffered elements belong to
        # the pre-restore order
        self.shutdown()
        self.base.restore_position(state)

    def queue_stats(self) -> Optional[Tuple[int, int]]:
        """``(occupancy, capacity)`` of the live output queue, or None
        when no asynchronous stream is active.  The driver loop samples
        this into each step event (``queue_depth`` / ``queue_capacity``),
        which tells a starved pipeline (occupancy pinned at 0) from a
        slow device (queue full)."""
        it = self._live
        if it is None:
            return None
        return it.depth(), self.queue_depth
