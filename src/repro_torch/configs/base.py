"""Model configuration of the port's dense decoders (the dense-decoder
part of ``repro.configs.base``): pre-norm blocks with RMSNorm (eps 1e-5),
RoPE, grouped-query attention, a SwiGLU MLP and a tied embedding head.

Defaults match the JAX package, including ``attn_impl="chunked"`` and
``use_decode_kernel=False``: with them the serving path reaches no
kernel. The launcher and ``chip_smoke.py`` set ``attn_impl="pallas"`` and
``use_decode_kernel=True`` so that on the card the path runs through the
hand-written CUDA kernels.
"""

from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense"]
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                   # 0 -> d_model // num_heads
    rope_theta: float = 10_000.0
    attn_impl: str = "chunked"          # dispatch (see core.attention)
    use_decode_kernel: bool = False     # split-KV paged decode kernel;
                                        # False = plain masked-softmax path
    num_decode_splits: int | None = None  # None = auto (kernels.tuning)
    dtype: str = "bfloat16"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"num_heads {self.num_heads} not a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")
