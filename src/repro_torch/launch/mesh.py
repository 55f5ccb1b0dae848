"""The production and test training meshes (port of
``repro.launch.mesh``): functions, so importing this module touches no
process group. Each builds this rank's ``distributed.meshes.Mesh`` over
the initialised default process group, whose world must be the product
of the shape: 256 ranks for ``(16, 16)`` over ``("data", "model")``, 512
for ``(2, 16, 16)`` with ``"pod"``; otherwise a ``ValueError`` names the
shape and the world size, as the reference's ``jax.make_mesh`` refuses a
device count that is not the shape's."""

from __future__ import annotations

from repro_torch.distributed.meshes import make_mesh


def make_production_mesh(*, multi_pod: bool = False, backend: str = "nccl",
                         device=None):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, backend=backend, device=device)


def make_test_mesh(data: int = 2, model: int = 4, *, backend: str = "gloo",
                   device=None):
    """A small ``("data", "model")`` mesh (8 ranks by default)."""
    return make_mesh((data, model), ("data", "model"), backend=backend,
                     device=device)
