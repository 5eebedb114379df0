"""gemma2-27b [dense]: local/global alternating attention + logit softcaps.

[arXiv:2408.00118; hf].
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-27b",
    family="dense",
    n_layers=46,
    d_model=4608,
    n_heads=32,
    n_kv_heads=16,
    d_ff=36864,
    vocab=256000,
    head_dim=128,
    window=4096,  # even layers local, odd layers global
    attn_softcap=50.0,
    final_softcap=30.0,
    post_norms=True,
    gated_act="gelu",
    rope_theta=1e4,
)
