"""Model configuration of the port's dense decoders (the dense-decoder
part of ``repro.configs.base``): pre-norm blocks (RMSNorm, LayerNorm or
non-parametric LayerNorm, eps 1e-5), RoPE, grouped-query attention with
optional qk-norm and a decoupled head_dim, a SwiGLU, GeGLU or GELU MLP,
and a tied or separate output head.

Defaults match the JAX package, including ``attn_impl="chunked"``,
``use_decode_kernel=False`` and ``remat=True``: with the first two the
serving and training paths reach no kernel. The launchers and
``chip_smoke.py`` set ``attn_impl="pallas"`` (and ``use_decode_kernel=True``
for serving) so that on the card the paths run through the hand-written
CUDA kernels.
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

    # attention
    attn_impl: str = "chunked"          # dispatch (see core.attention)
    causal: bool = True
    window: int | None = None           # causal sliding window
    qk_norm: bool = False               # RMS-normalize q and k per head
    rope_theta: float = 10_000.0
    attn_dropout: float = 0.0
    # kernel tile geometry: None = auto (kernels.tuning)
    attn_block_q: int | None = None
    attn_block_k: int | None = None
    num_decode_splits: int | None = None  # None = auto (kernels.tuning)
    use_decode_kernel: bool = False     # split-KV decode kernel;
                                        # False = plain masked-softmax path

    # norms / mlp
    norm_type: Literal["rmsnorm", "layernorm", "layernorm_np"] = "rmsnorm"
    mlp_type: Literal["swiglu", "geglu", "gelu"] = "swiglu"

    tie_embeddings: bool = True         # False: a separate (d_model, V) head
    dtype: str = "bfloat16"
    remat: bool = True                  # activation checkpoint each block

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"num_heads {self.num_heads} not a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")
