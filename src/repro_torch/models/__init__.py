"""Dense decoder model: layers, attention layer, stack, Model."""

from repro_torch.models.model_zoo import (Model, build_model, params_from_jax,
                                         params_to)

__all__ = ["Model", "build_model", "params_from_jax", "params_to"]
