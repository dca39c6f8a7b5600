"""zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64 — Mamba2 backbone + one SHARED attention+MLP block
applied every 6 SSM blocks with per-invocation LoRA adapters.
[arXiv:2411.15242; hf]

Hybrid (mostly-SSM) ⇒ ``long_500k`` runs; the shared attention invocations
use the full cache at decode (cheap: a handful of invocations).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    source="[arXiv:2411.15242; hf]",
    num_layers=38,  # mamba2 blocks
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,  # shared block is MHA
    head_dim=64,
    d_ff=8192,  # shared block MLP
    vocab_size=32_000,
    attn_kind="full",
    ssm_version=2,
    ssm_state=64,
    ssm_conv=4,
    ssm_expand=2,  # d_inner = 4096
    ssm_head_dim=64,  # 64 mamba2 heads
    attn_every=6,  # shared block at SSM blocks 0,6,12,18,24,30,36
    shared_lora_rank=64,
    rope_theta=10_000.0,
    ssm_algo="ssd",  # §Perf B1: 6.4x lower memory term than the elementwise
    #                  scan (numerically identical); baseline via --ssm-algo scan
)
