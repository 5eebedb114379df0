"""minicpm3-4b [dense/MLA]: multi-head latent attention. [hf:openbmb/MiniCPM3-4B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="mla",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,  # MLA: per-head latents, no GQA grouping
    d_ff=6400,
    vocab=73448,
    q_lora=768,
    kv_lora=256,
    qk_nope=64,
    qk_rope=32,
    v_head=64,
    rope_theta=1e4,
)
