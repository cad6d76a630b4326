"""Counter-based dropout masks (the port's stand-in for the JAX
package's ``jax.random.bernoulli`` draws in ``MultiHeadAttention``,
``bigdl_tpu/nn/attention.py:466-469``).

A mask is a pure function of three integers: the training step's KEY
(a 0-d int64 tensor on the device), a SALT (the layer index) and each
element's flat index, mixed by an integer hash written in torch ops.  So

- the recompute of a rematerialised layer draws the mask the forward
  drew (``torch.utils.checkpoint`` restores only the default
  generators, and the recompute reads no generator at all);
- the CPU and the card draw the same mask from one key;
- the train step advances its key on the device after every step
  (``make_train_step``), so every replay of a captured step draws new
  masks with no host involvement.

The masks cannot equal JAX's threefry bits: they are held by their keep
rate, by identity in eval mode, and by remat leaving the gradients as
they are.

The key is set for the length of a step by ``step_key``; a module-level
slot (not thread-local), because the autograd engine recomputes a
checkpointed layer on a thread of its own.  Without a key no mask is
drawn, as the JAX layer draws none without an ``rng``.
"""

import contextlib
import zlib

import torch

_MASK32 = 0xFFFFFFFF
#: the training step's key while a step runs (``step_key``)
_current = None


def _mix(x):
    """A 32-bit integer hash (xorshift-multiply rounds) of int64 values
    in [0, 2^32): every product stays below 2^63."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _MASK32
    x = x ^ (x >> 15)
    x = (x * 0x1B873593) & _MASK32
    return x ^ (x >> 16)


def hash_bits(key, salt: int, n: int, device):
    """``n`` 32-bit values (int64), a hash of (``key``, ``salt``, each
    index): the draws of a counter-based stream (also the int8 wire's
    stochastic rounding, ``ops/quantization.py``)."""
    seed = _mix((key.to(device=device, dtype=torch.int64) * 0x2545F491
                 + int(salt) * 0x68E31DA5) & _MASK32)
    idx = torch.arange(n, dtype=torch.int64, device=device)
    return _mix(_mix(idx ^ seed) ^ ((seed * 0x3C6EF35F) & _MASK32))


def keep_mask(key, salt: int, shape, keep: float, device):
    """Boolean mask of ``shape``, each element True with probability
    ``keep``: a hash of (``key``, ``salt``, its flat index)."""
    n = 1
    for d in shape:
        n *= int(d)
    bits = hash_bits(key, salt, n, device)
    return (bits < int(keep * 2 ** 32)).reshape(shape)


def dropout(x, rate: float, salt: int):
    """``x`` with each element zeroed at ``rate`` and the kept ones
    scaled by ``1 / (1 - rate)`` under the current step's key (as the
    JAX layer computes it, in ``x``'s dtype); ``x`` itself when no step
    key is set or ``rate`` is 0."""
    key = _current
    if key is None or rate <= 0:
        return x
    keep = 1.0 - rate
    mask = keep_mask(key, salt, x.shape, keep, x.device)
    return torch.where(mask, x / keep, torch.zeros_like(x)).to(x.dtype)


@contextlib.contextmanager
def step_key(key):
    """Draw dropout masks from ``key`` (a 0-d int64 tensor, or None for
    none) inside the block."""
    global _current
    outer, _current = _current, key
    try:
        yield key
    finally:
        _current = outer


def uses_dropout(model) -> bool:
    """Whether a module of ``model`` draws a dropout mask."""
    return any(getattr(m, "dropout", 0) > 0 for m in model.modules())


def salt_by_path(model):
    """Give every ``Dropout`` layer of ``model`` (a module with
    ``salt_by_path``) the salt of its path in the model, so two models
    built alike draw the same masks from one key whatever order they
    were built in."""
    for path, m in model.named_modules():
        if getattr(m, "salt_by_path", False):
            m.dropout_salt = zlib.crc32(path.encode())


def new_step_key(generator, device):
    """A step key drawn from ``generator`` (the port's random stream),
    placed on ``device``."""
    seed = int(torch.randint(0, 2 ** 31, (), generator=generator))
    return torch.tensor(seed, dtype=torch.int64, device=device)
