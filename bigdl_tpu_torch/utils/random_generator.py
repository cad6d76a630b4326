"""Seeded random stream for the training step (counterpart of
``bigdl_tpu/utils/random_generator.py``).

The JAX package splits ``jax.random`` keys; here the stream is an
explicit ``torch.Generator`` on the CPU, and ``next_generator()`` hands
out a fresh generator seeded from it.  The two packages draw different
numbers from one seed: tests make their random inputs with numpy.
"""

import threading

import torch


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


#: Global generator, mirroring ``RandomGenerator.RNG`` in the reference.
RNG = RandomGenerator()
