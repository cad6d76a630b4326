"""Weights, model state and optimizer states between the port and the JAX
package's trees, both ways."""

from bigdl_tpu_torch.interop.jax_params import (from_jax_opt_state,
                                                load_jax_opt_state,
                                                load_jax_params,
                                                load_jax_pp_opt_state,
                                                load_jax_pp_params,
                                                load_jax_state,
                                                to_jax_opt_state,
                                                to_jax_params,
                                                to_jax_pp_opt_state,
                                                to_jax_pp_params, to_jax_state)

__all__ = ["from_jax_opt_state", "load_jax_opt_state", "load_jax_params",
           "load_jax_pp_opt_state", "load_jax_pp_params", "load_jax_state",
           "to_jax_opt_state", "to_jax_params", "to_jax_pp_opt_state",
           "to_jax_pp_params", "to_jax_state"]
