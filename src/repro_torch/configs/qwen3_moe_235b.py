"""qwen3-moe-235b-a22b [moe]: 128 experts top-8, GQA kv=4. [hf:Qwen/Qwen3-...]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=0,  # no shared dense FFN
    vocab=151936,
    head_dim=128,
    n_experts=128,
    top_k=8,
    d_ff_expert=1536,
    rope_theta=1e6,
)
