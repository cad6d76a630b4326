"""Loading weights and optimizer states from the JAX package's trees."""

from bigdl_tpu_torch.interop.jax_params import (load_jax_opt_state,
                                                load_jax_params)

__all__ = ["load_jax_opt_state", "load_jax_params"]
