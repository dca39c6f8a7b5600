"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753, WSD schedule, llama-like.  [arXiv:2404.06395; hf]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    source="[arXiv:2404.06395; hf]",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,  # MHA (kv == heads)
    head_dim=64,
    d_ff=5760,
    vocab_size=122_753,
    attn_kind="full",
    rope_theta=10_000.0,
    schedule="wsd",  # warmup-stable-decay, per the paper
    tie_embeddings=True,  # minicpm ties input/output embeddings
)
