"""seamless-m4t-medium [audio]: encoder-decoder backbone; speech frontend is
a stub providing precomputed frame embeddings. [arXiv:2308.11596; hf]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=24,  # 12 encoder + 12 decoder
    enc_layers=12,
    dec_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    frontend="audio",
    tie_embeddings=False,
)
