"""Seeded random stream for the training step (counterpart of
``bigdl_tpu/utils/random_generator.py``).

The JAX package splits ``jax.random`` keys; here the stream is an
explicit ``torch.Generator`` on the CPU, and ``next_generator()`` hands
out a fresh generator seeded from it.  The two packages draw different
numbers from one seed: tests make their random inputs with numpy.

A stream position is a pair of 32-bit words, the layout of a JAX
threefry key's data (``uint32``, shape (2,)), so a checkpoint's
``rng_state`` loads in either package.  ``get_state`` draws the pair
from the stream and re-seeds the stream from it; ``set_state`` seeds it
from a pair.  So a run that wrote a checkpoint and a run resumed from it
continue from the same seed, and a JAX key seeds the port's stream
deterministically (to other numbers than JAX's).
"""

import threading

import numpy as np
import torch


def _seed_of(words) -> int:
    hi, lo = (int(w) for w in np.asarray(words, dtype=np.uint32).reshape(2))
    return (hi << 32) | lo


class RandomGenerator:
    """``set_seed`` resets the stream; ``next_generator`` returns a new
    ``torch.Generator`` (on ``device``) seeded from the stream, advancing
    it.  Thread-safe."""

    def __init__(self, seed: int = 1):
        self._lock = threading.Lock()
        self.set_seed(seed)

    def set_seed(self, seed: int) -> "RandomGenerator":
        with self._lock:
            self._seed = int(seed)
            self._stream = torch.Generator().manual_seed(self._seed)
        return self

    def get_seed(self) -> int:
        return self._seed

    def next_generator(self, device="cpu") -> torch.Generator:
        with self._lock:
            sub = int(torch.randint(0, 2 ** 62, (), generator=self._stream))
        return torch.Generator(device=device).manual_seed(sub)

    def get_state(self):
        """The stream position as a ``uint32`` pair; the stream goes on
        from that pair, as ``set_state`` would start it."""
        with self._lock:
            words = torch.randint(0, 2 ** 32, (2,), generator=self._stream,
                                  dtype=torch.int64).numpy().astype(np.uint32)
            self._stream = torch.Generator().manual_seed(_seed_of(words))
        return words

    def set_state(self, data) -> "RandomGenerator":
        """Seed the stream from a ``get_state`` pair (either package's)."""
        with self._lock:
            self._stream = torch.Generator().manual_seed(_seed_of(data))
        return self


#: Global generator, mirroring ``RandomGenerator.RNG`` in the reference.
RNG = RandomGenerator()
