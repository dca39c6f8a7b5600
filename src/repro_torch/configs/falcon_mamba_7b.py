"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attn-free) vocab=65024,
ssm_state=16 — mamba1 architecture.  [arXiv:2410.05355; unverified]

Attention-free: no KV cache; decode state is the (d_inner, d_state) SSM
state + conv tail per layer, so the ``long_500k`` cell runs.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    source="[arXiv:2410.05355; unverified]",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,  # attn-free mamba1 block has no separate MLP
    vocab_size=65_024,
    attn_kind="none",
    ssm_version=1,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,  # d_inner = 8192
    dt_rank=256,  # d_model / 16
    tie_embeddings=False,
)
