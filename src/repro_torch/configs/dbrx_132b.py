"""dbrx-132b [moe] — 40L d_model=6144 48H (GQA kv=8) d_ff=10752
vocab=100352, MoE 16e top-4, fine-grained.  [hf:databricks/dbrx-base; unverified]
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="[hf:databricks/dbrx-base; unverified]",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=10_752,
    vocab_size=100_352,
    attn_kind="full",
    num_experts=16,
    num_shared_experts=0,
    top_k=4,
    moe_d_ff=10_752,
    first_dense_layers=0,
    rope_theta=500_000.0,
    moe_group_size=8_192,  # §Perf C1: fewer group-scan trips; dispatch buffer
    #                        (16, 2560, 6144) bf16 = 0.5 GB stays remat-able
)
