"""The models: layers, attention layer, stacks, Model."""

from repro_torch.models.model_zoo import (Model, build_model, params_from_jax,
                                         params_to, require_token_inputs)

__all__ = ["Model", "build_model", "params_from_jax", "params_to",
           "require_token_inputs"]
