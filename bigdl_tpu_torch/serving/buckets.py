"""Bucket ladders for serving (the port's copy of
``bigdl_tpu/serving/buckets.py``).

Batch sizes and prompt lengths round up to a fixed geometric ladder, so
the set of shapes the serving steps see is closed and can be warmed up
front (``ServingEngine.precompile``); padded rows ride along as zeros
and are discarded on return.  A length ladder does the same for the time
axis of sequence inputs (``pad_length_axis``).
"""

import bisect
import threading
from typing import Iterator, List, Optional

import numpy as np


class BucketLadder:
    """A sorted set of allowed sizes; ``bucket_for(n)`` rounds up.

    ``align`` forces every rung to a multiple (the sharded predict path
    needs batch buckets divisible by the mesh's data-axis size);
    ``growth`` is the geometric step between rungs (2 by default, so
    pad waste is bounded by ~2x on any rung).

    Thread-safe: the engine's dispatcher thread can grow the ladder
    (an over-max length in ``pad_length_axis``) while caller threads
    read it (``predict_at``, ``precompile``), so lookups/mutation take
    a lock and iteration walks a snapshot.
    """

    def __init__(self, max_size: int, min_size: int = 1, growth: int = 2,
                 align: int = 1):
        if min_size < 1 or max_size < min_size:
            raise ValueError(
                f"need 1 <= min_size <= max_size, got {min_size}/{max_size}")
        if growth < 2:
            raise ValueError(f"growth must be >= 2, got {growth}")
        self.align = max(1, int(align))
        self._lock = threading.Lock()
        rungs = set()
        b = int(min_size)
        while b < max_size:
            rungs.add(self._aligned(b))
            b *= growth
        rungs.add(self._aligned(int(max_size)))
        self.rungs: List[int] = sorted(rungs)

    def _aligned(self, n: int) -> int:
        return -(-n // self.align) * self.align

    @property
    def max(self) -> int:
        return self.rungs[-1]

    @property
    def min(self) -> int:
        return self.rungs[0]

    def bucket_for(self, n: int) -> Optional[int]:
        """Smallest rung >= n, or None when n exceeds the ladder."""
        with self._lock:
            i = bisect.bisect_left(self.rungs, n)
            return self.rungs[i] if i < len(self.rungs) else None

    def add(self, n: int) -> int:
        """Insert (the aligned) ``n`` as a rung; returns the rung."""
        n = self._aligned(int(n))
        with self._lock:
            i = bisect.bisect_left(self.rungs, n)
            if i == len(self.rungs) or self.rungs[i] != n:
                self.rungs.insert(i, n)
        return n

    def copy(self) -> "BucketLadder":
        """An independent ladder with the same rungs and alignment.
        Consumers that grow their ladder (``add`` on over-max sizes)
        copy at construction, so a ladder shared between consumers
        never accumulates rungs another consumer added -- each keeps
        its own closed, warmable shape set."""
        new = BucketLadder.__new__(BucketLadder)
        new.align = self.align
        new._lock = threading.Lock()
        with self._lock:
            new.rungs = list(self.rungs)
        return new

    def __iter__(self) -> Iterator[int]:
        with self._lock:
            return iter(list(self.rungs))

    def __len__(self) -> int:
        with self._lock:
            return len(self.rungs)

    def __contains__(self, n) -> bool:
        with self._lock:
            return n in self.rungs

    def __repr__(self):
        return f"BucketLadder({self.rungs}, align={self.align})"


def _pad0(a, target: int):
    a = np.asarray(a)
    if a.shape[0] == target:
        return a
    if a.shape[0] > target:
        raise ValueError(f"batch {a.shape[0]} exceeds bucket {target}")
    out = np.zeros((target,) + a.shape[1:], a.dtype)
    out[: a.shape[0]] = a
    return out


def pad_batch_axis(tree, target: int):
    """Zero-pad every leaf's batch axis (0) up to ``target`` rows.
    Nested tuple/list activities are walked like the MiniBatch pytree."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(pad_batch_axis(e, target) for e in tree)
    return _pad0(tree, target)


def walk_length_leaves(tree, select, leaf_fn, batched: bool = True):
    """The one depth-first walk behind length bucketing: ``leaf_fn`` on
    every leaf eligible for time-axis bucketing, the others passed
    through.  ``pad_length_axis`` (traffic, batched-rank leaves) and
    ``ServingEngine.precompile`` (warm-up, sample-rank leaves,
    ``batched=False``) share it, so their leaf numbering, rank gate and
    ``select`` semantics agree; ``select`` always sees the leaf at
    batched rank."""
    counter = [0]
    min_rank = 2 if batched else 1

    def walk(t):
        if isinstance(t, (tuple, list)):
            return type(t)(walk(e) for e in t)
        a = np.asarray(t)
        i = counter[0]
        counter[0] += 1
        if a.ndim < min_rank:
            return a
        if select is not None and not select(i, a if batched else a[None]):
            return a
        return leaf_fn(a)

    return walk(tree)


def pad_length_axis(tree, ladder: BucketLadder, select=None):
    """Round every rank >= 2 leaf's time axis (1) up to the length ladder
    with zeros (tokens past the true length are padding the model must
    mask, as in training).  A length past the ladder's largest rung adds
    that length as a rung, so it is reused.

    ``select``: optional ``(leaf_index, leaf) -> bool`` choosing which
    rank >= 2 leaves are bucketed (depth-first numbering over the whole
    tree, the leaf at batched rank).  By default all are, which is wrong
    for a fixed-width rank >= 2 side input: exclude it here
    (``ServingEngine(length_select=)``)."""

    def pad(a):
        target = ladder.bucket_for(a.shape[1])
        if target is None:
            target = ladder.add(a.shape[1])
        if target == a.shape[1]:
            return a
        out = np.zeros((a.shape[0], target) + a.shape[2:], a.dtype)
        out[:, : a.shape[1]] = a
        return out

    return walk_length_leaves(tree, select, pad, batched=True)


def slice_batch_axis(tree, n: int):
    """Inverse of ``pad_batch_axis``: the first ``n`` (real) rows."""
    if isinstance(tree, (tuple, list)):
        return type(tree)(slice_batch_axis(e, n) for e in tree)
    return tree[:n]


def ladder_or_default(ladder: Optional[BucketLadder], max_size: int,
                      align: int = 1) -> BucketLadder:
    """A COPY of the caller-supplied ladder (validated against
    ``align``) or the default geometric one covering [align, max_size].
    The copy keeps the consumer's own rung growth (``add``) from
    leaking into a ladder the caller shares with other consumers."""
    if ladder is None:
        return BucketLadder(max_size, min_size=1, align=align)
    bad = [r for r in ladder if r % align]
    if bad:
        raise ValueError(
            f"ladder rungs {bad} not divisible by the device alignment "
            f"{align} (sharded predict splits the batch axis evenly)")
    return ladder.copy()
