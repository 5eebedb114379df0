"""Model/architecture configuration shared by all assigned architectures."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | mla | moe | ssm | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 1e4
    # gemma2-style features
    window: Optional[int] = None  # local-attention window (alternating layers)
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    post_norms: bool = False
    gated_act: str = "silu"  # silu | gelu
    # MLA (minicpm3 / deepseek style)
    q_lora: int = 0
    kv_lora: int = 0
    qk_nope: int = 0
    qk_rope: int = 0
    v_head: int = 0
    # MoE
    n_experts: int = 0
    top_k: int = 0
    d_ff_expert: int = 0
    dense_ff_parallel: bool = False  # arctic: dense FFN residual + MoE
    moe_capacity: float = 1.25
    moe_impl: str = "dense_ec"  # dense_ec | ragged
    # SSM (mamba2 SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    conv_width: int = 4
    ssm_chunk: int = 64
    # hybrid (zamba2): one shared attention block applied every `attn_every`
    attn_every: int = 0
    # encoder-decoder (seamless)
    enc_layers: int = 0
    dec_layers: int = 0
    # modality frontend stub: precomputed embeddings prepended/consumed
    frontend: Optional[str] = None  # None | vlm | audio
    frontend_len: int = 0
    tie_embeddings: bool = True
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"  # activation dtype
    param_dtype: str = "float32"  # "bfloat16" halves weight collectives
    moe_local_dispatch: bool = False  # per-data-shard capacity (EP all_to_all)
    # which shapes this arch supports (see launch.shapes)
    supports_long_context: bool = False  # sub-quadratic decode (ssm/hybrid)

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def d_inner(self) -> int:  # mamba2 inner width
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    def n_params(self) -> int:
        """Approximate parameter count (for 6ND roofline accounting)."""
        d, v = self.d_model, self.vocab
        hd = self.hd
        emb = v * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "moe", "encdec"):
            per_layer += d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
            per_layer += (self.n_heads * hd) * d
        if self.family == "mla":
            per_layer += d * self.q_lora + self.q_lora * self.n_heads * (
                self.qk_nope + self.qk_rope
            )
            per_layer += d * (self.kv_lora + self.qk_rope)
            per_layer += self.kv_lora * self.n_heads * (self.qk_nope + self.v_head)
            per_layer += self.n_heads * self.v_head * d
        if self.family in ("dense", "mla", "encdec"):
            per_layer += 3 * d * self.d_ff
        if self.family == "moe":
            per_layer += 3 * d * self.d_ff_expert * self.n_experts
            per_layer += d * self.n_experts  # router
            if self.dense_ff_parallel:
                per_layer += 3 * d * self.d_ff
        if self.family == "ssm":
            di, n = self.d_inner, self.ssm_state
            per_layer += d * (2 * di + 2 * n + self.ssm_heads) + di * d
        if self.family == "hybrid":
            di, n = self.d_inner, self.ssm_state
            per_layer += d * (2 * di + 2 * n + self.ssm_heads) + di * d
        n_layers = self.n_layers
        total = emb + per_layer * n_layers
        if self.family == "hybrid" and self.attn_every:
            # one shared attention+mlp block
            total += d * (self.n_heads * hd) * 2 + 2 * d * (self.n_kv_heads * hd)
            total += 3 * d * self.d_ff
        if self.family == "encdec":
            # decoder cross-attention
            total += self.dec_layers * (
                d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd)
                + (self.n_heads * hd) * d
            )
        return int(total)

    def active_params(self) -> int:
        """Active params per token (MoE: top-k experts only)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        total = self.n_params()
        moe_all = 3 * d * self.d_ff_expert * self.n_experts * self.n_layers
        moe_active = 3 * d * self.d_ff_expert * self.top_k * self.n_layers
        return int(total - moe_all + moe_active)
