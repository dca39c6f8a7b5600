"""qwen3-14b [dense] — 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm + GQA.  [hf:Qwen/Qwen3-8B; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    family="dense",
    source="[hf:Qwen/Qwen3-8B; hf]",
    num_layers=40,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=17_408,
    vocab_size=151_936,
    attn_kind="full",
    qk_norm=True,  # per-head RMSNorm on q and k (qwen3)
    rope_theta=1_000_000.0,
)
