"""internvl2-26b [vlm]: InternViT frontend (stub) + InternLM2-20B backbone.

[arXiv:2404.16821; hf]. Backbone only per assignment; the vision frontend is
a stub providing precomputed patch embeddings via input_specs().
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="dense",
    n_layers=48,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=16384,
    vocab=92553,
    head_dim=128,
    rope_theta=1e6,
    frontend="vlm",
    frontend_len=256,  # patch embeddings per image (stubbed)
    tie_embeddings=False,
)
