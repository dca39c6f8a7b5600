"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + (Llama-3-70B-class) LM backbone.
[arXiv:2404.16821; unverified]

Per the assignment, the ViT frontend is a STUB: ``input_specs()`` provides
precomputed patch embeddings (num_prefix_tokens x d_model) that are prepended
to the text token stream; only the LM backbone is modeled.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    source="[arXiv:2404.16821; unverified]",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=128_256,
    attn_kind="full",
    rope_theta=500_000.0,
    frontend="vit_stub",
    num_prefix_tokens=256,  # vision tokens per sample
)
