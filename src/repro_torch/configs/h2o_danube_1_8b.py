"""h2o-danube-1.8b [dense] — 24L d_model=2560 32H (GQA kv=8) d_ff=6912
vocab=32000 — llama+mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]

SWA makes attention sub-quadratic in context length, so this arch runs the
``long_500k`` cell (decode KV cache is bounded by the window).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    source="[arXiv:2401.16818; hf]",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    head_dim=80,
    d_ff=6912,
    vocab_size=32_000,
    attn_kind="swa",
    window=4_096,  # mistral-style sliding window
    rope_theta=10_000.0,
)
