"""Transformer LM model family (counterpart of
``bigdl_tpu/models/transformer.py``)."""

import numpy as np

from bigdl_tpu_torch.nn.attention import TransformerLM


#: size -> (hidden, heads, layers), the JAX package's table
CONFIGS = {
    "tiny":  (256,   4,    4),
    "small": (768,  12,   12),
    "medium": (1024, 16,  24),
    "large": (1536, 16,   36),
}


def transformer_lm(size: str = "tiny", vocab_size: int = 32000,
                   max_len: int = 2048, use_flash: str = "auto",
                   device=None, seed: int = 0, scan_layers=None,
                   remat_policy=None, seq_axis_name=None,
                   seq_mode="ring") -> TransformerLM:
    """A named config with random weights drawn from ``seed``, placed on
    ``device`` (``None`` means the CUDA card).

    ``scan_layers=None`` is the JAX package's AUTO rule: "medium" and
    "large" hold their blocks scanned (one stacked ``"blocks"`` entry,
    every layer rematerialised in training), "tiny" and "small"
    unrolled (and a sequence-parallel model always, as in JAX); True or
    False forces the layout.  ``remat_policy`` names a ``nn.containers``
    remat policy applied per block in training; ``seq_axis_name`` and
    ``seq_mode`` are ``TransformerLM``'s sequence-parallel hooks."""
    if size not in CONFIGS:
        raise ValueError(f"unknown size {size!r}; pick from {list(CONFIGS)}")
    hidden, heads, layers = CONFIGS[size]
    if scan_layers is None:
        scan_layers = size in ("medium", "large") and seq_axis_name is None
    return TransformerLM(vocab_size, hidden, heads, layers, max_len=max_len,
                         use_flash=use_flash, device=device, seed=seed,
                         scan_layers=scan_layers, remat_policy=remat_policy,
                         seq_axis_name=seq_axis_name, seq_mode=seq_mode)


def synthetic_corpus(n_seq: int, seq_len: int, vocab_size: int, seed=0):
    """Next-token-prediction pairs from a Markov-ish synthetic stream --
    the same numpy draws as the JAX package's, so both packages see the
    same tokens for one seed."""
    rng = np.random.default_rng(seed)
    trans = rng.integers(0, vocab_size, size=(vocab_size, 4))
    toks = np.empty((n_seq, seq_len + 1), np.int32)
    toks[:, 0] = rng.integers(0, vocab_size, n_seq)
    choice = rng.integers(0, 4, size=(n_seq, seq_len))
    for t in range(seq_len):
        toks[:, t + 1] = trans[toks[:, t], choice[:, t]]
    return toks[:, :-1], toks[:, 1:]
