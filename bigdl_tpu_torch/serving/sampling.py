"""Token sampling on the device: temperature / top-k / top-p (counterpart
of ``bigdl_tpu/serving/sampling.py``).

Every slot carries its knobs as one row of runtime tensors, so greedy and
sampled rows share one step.  The draw is Gumbel-max over the masked,
temperature-scaled logits, with the noise from a counter-based generator
keyed on ``(seed, position, rank)``: the token drawn at sequence position
``p`` depends only on ``(seed, p)`` and the logits, so a request replays
the same stream whichever slot it lands in and however its prompt was
chunked.  The noise is not ``jax.random``'s threefry stream, so sampled
tokens do not match the JAX package's bit for bit; greedy rows
(``temperature <= 0``) do.
"""

import torch


class SamplingParams:
    """Per-request sampling knobs, validated once at submission.

    ``temperature <= 0`` is greedy (top_k/top_p ignored); ``top_k <= 0``
    disables the k-cut; ``top_p`` keeps the smallest set of tokens whose
    probability mass reaches it (``1.0`` disables).  ``seed=None`` asks
    the scheduler to mint one -- pass a seed for deterministic replay.
    """

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature=0.0, top_k=0, top_p=1.0, seed=None):
        temperature = float(temperature)
        top_k = int(top_k)
        top_p = float(top_p)
        if not temperature == temperature:            # NaN
            raise ValueError("temperature must not be NaN")
        if top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {top_k}")
        if not 0.0 <= top_p <= 1.0:
            raise ValueError(f"top_p must be in [0, 1], got {top_p}")
        if seed is not None:
            seed = int(seed)
            if not 0 <= seed < 2 ** 31:
                raise ValueError(f"seed must fit in 31 bits, got {seed}")
        self.temperature = temperature
        self.top_k = top_k
        self.top_p = top_p
        self.seed = seed

    @property
    def greedy(self):
        return self.temperature <= 0.0

    def __repr__(self):
        return (f"SamplingParams(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, "
                f"seed={self.seed})")


_M32 = 0xFFFFFFFF


def _mix32(x):
    """A 32-bit integer hash on int64 tensors holding values < 2**32
    (every product stays below 2**63, so nothing overflows)."""
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    x = (((x >> 16) ^ x) * 0x45D9F3B) & _M32
    return (x >> 16) ^ x


def gumbel_noise(seed, position, vocab):
    """``(rows, vocab)`` standard Gumbel noise, a pure function of each
    row's ``(seed, position)`` and the column index."""
    dev = seed.device
    key = _mix32(_mix32(seed.long() & _M32) ^ (position.long() & _M32))
    col = torch.arange(vocab, dtype=torch.int64, device=dev)
    h = _mix32((key[:, None] + col[None, :] * 0x9E3779B1) & _M32)
    u = (h.double() + 0.5) / 2.0 ** 32
    return (-torch.log(-torch.log(u))).float()


def sample_tokens(logits, temperature, top_k, top_p, seed, position):
    """Draw one token per row.

    logits       (rows, vocab) float
    temperature  (rows,) float; <= 0 selects greedy for that row
    top_k        (rows,) int; <= 0 disables
    top_p        (rows,) float in [0, 1]
    seed         (rows,) int per-request seed
    position     (rows,) int sequence position of the token being drawn

    Returns (rows,) int32 token ids.
    """
    vocab = logits.shape[-1]
    logits = logits.float()
    greedy = torch.argmax(logits, dim=-1)
    # sorted order (descending, ties by index like jnp.argsort): top-k is
    # a rank cut and top-p a cumulative-mass cut over the same sort
    ranked, order = torch.sort(logits, dim=-1, descending=True, stable=True)
    temp = temperature.float().clamp_min(1e-6)[:, None]
    scaled = ranked / temp
    rank = torch.arange(vocab, device=logits.device)[None, :]
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab))
    keep = rank < k[:, None]
    probs = torch.softmax(scaled, dim=-1)
    # keep a token iff the mass strictly before it is < top_p; rank 0
    # always survives
    mass_before = torch.cumsum(probs, dim=-1) - probs
    keep = keep & (mass_before < top_p.float()[:, None])
    keep[:, 0] = True
    masked = torch.where(keep, scaled, torch.full_like(scaled,
                                                       float("-inf")))
    pick = torch.argmax(masked + gumbel_noise(seed, position, vocab), dim=-1)
    sampled = torch.gather(order, 1, pick[:, None])[:, 0]
    return torch.where(temperature > 0.0, sampled, greedy).to(torch.int32)
