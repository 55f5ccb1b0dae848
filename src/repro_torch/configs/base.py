"""Model configuration of the port's decoders (the dense, mixture-of-experts,
state-space and hybrid parts of ``repro.configs.base``): pre-norm blocks
(RMSNorm, LayerNorm or non-parametric LayerNorm, eps 1e-5), RoPE,
grouped-query attention with optional qk-norm and a decoupled head_dim, a
SwiGLU, GeGLU or GELU MLP (``family="dense"``) or a top-k routed SwiGLU
mixture of experts with capacity-factor dropping (``family="moe"``),
attention-free Mamba2 (SSD) blocks (``family="ssm"``), Hymba's parallel
attention + SSM heads (``family="hybrid"``) or an encoder-decoder
(``family="encdec"``: a non-causal encoder of ``num_encoder_layers``
blocks over a modality frontend's projected frames, then decoder blocks
with cross-attention) or a vision-language decoder (``family="vlm"``: a
frontend's projected patches prepended to the token embeddings), and a
tied or separate output head. ``ShapeConfig`` / ``SHAPES`` /
``cell_is_applicable``: the dry-run's input shapes
(``launch/dryrun.py``).

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
    family: Literal["dense", "moe", "ssm", "hybrid", "encdec", "vlm"]
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
    # the chunked path's levers (the reference's defaults)
    attn_chunk_size: int = 1024         # Alg.-1 kv chunk of ``chunked``
    attn_pv_bf16: bool = False          # bf16 P and V for P@V (fp32 sums)
    banded_window: bool = False         # banded layout for window attention

    # norms / mlp
    norm_type: Literal["rmsnorm", "layernorm", "layernorm_np"] = "rmsnorm"
    mlp_type: Literal["swiglu", "geglu", "gelu"] = "swiglu"

    # MoE (family "moe"): experts of d_ff each, top-k per token, expert
    # buffers of capacity_factor * s * k / num_experts rows per sequence
    num_experts: int = 0
    num_experts_per_token: int = 0
    moe_capacity_factor: float = 1.25

    # SSM (Mamba2 / SSD; families "ssm" and "hybrid")
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    fast_conv: bool = False             # depthwise conv1d stem (vs shifts)
    ssm_decay_dtype: str = "float32"    # SSD intra-chunk decay operand dtype

    # hybrid (Hymba): parallel attention + SSM heads in one block
    hybrid: bool = False

    # encoder-decoder (seamless-m4t)
    num_encoder_layers: int = 0          # >0 -> enc-dec; num_layers = decoder

    # modality frontend stubs: the batch carries precomputed embeddings
    frontend: Literal[None, "vision", "audio"] = None
    frontend_tokens: int = 0             # vision: patch tokens prepended
    frontend_dim: int = 0                # raw embedding dim before projection

    tie_embeddings: bool = True         # False: a separate (d_model, V) head
    dtype: str = "bfloat16"
    remat: bool = True                  # activation checkpoint each block

    # tensor and sequence parallelism (serving; DESIGN.md §13-§14): the
    # GLOBAL shard counts, carried by a per-shard config (whose head and
    # d_ff counts are the per-shard ones) for the decode split target
    # (``kernels.tuning.decode_split_target``); ``sp_strategy`` is how a
    # chunk's K/V slabs reach every sp rank ("allgather" or "ring",
    # ``kernels.tuning.resolve_sp_strategy``). The mesh itself is passed
    # to the model explicitly (``distributed.meshes.ServeMesh``).
    tp_shards: int = 1
    sp_shards: int = 1
    sp_strategy: str = "allgather"

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // max(self.num_heads, 1))
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError(f"num_heads {self.num_heads} not a multiple of "
                             f"num_kv_heads {self.num_kv_heads}")

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_num_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dry-run's cells (``repro.configs.base``)."""
    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def cell_is_applicable(cfg: ModelConfig,
                       shape: ShapeConfig) -> tuple[bool, str]:
    """long_500k runs only for sub-quadratic archs (SSM, or a hybrid with
    a window); pure full-attention archs skip it (DESIGN.md §4)."""
    if shape.name == "long_500k":
        if cfg.family == "ssm" or (cfg.hybrid and cfg.window is not None):
            return True, ""
        return False, ("pure full-attention arch: long_500k requires "
                       "sub-quadratic attention (assignment rule; "
                       "block-sparse flash available as opt-in)")
    return True, ""
