"""arctic-480b [moe]: 128 experts top-2 + dense FFN residual in parallel.

[hf:Snowflake/snowflake-arctic-base].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,  # dense residual FFN (parallel to the MoE)
    vocab=32000,
    head_dim=128,
    n_experts=128,
    top_k=2,
    d_ff_expert=4864,
    dense_ff_parallel=True,
)
