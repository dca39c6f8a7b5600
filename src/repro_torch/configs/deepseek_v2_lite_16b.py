"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64e top-6 — MLA kv_lora=512, 2 shared + routed experts.
[arXiv:2405.04434; hf]

Notes: the assignment's primary line specifies 64 routed experts top-6 with
expert d_ff=1408 (the "160 routed" aside describes full DeepSeek-V2; we follow
the primary line).  Layer 0 is dense (d_ff=10944, per the HF config); layers
1..26 are MoE with 2 shared experts.  MLA caches the 512-dim compressed c_kv +
64-dim decoupled rope key per token instead of full K/V — the arch's native
"KV compression", synergistic with DaeMon link compression (see DESIGN.md).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    source="[arXiv:2405.04434; hf]",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=192,  # qk_nope(128) + qk_rope(64)
    d_ff=10_944,  # dense first layer
    vocab_size=102_400,
    attn_kind="mla",
    kv_lora_rank=512,
    qk_nope_dim=128,
    qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64,
    num_shared_experts=2,
    top_k=6,
    moe_d_ff=1408,
    first_dense_layers=1,
    rope_theta=10_000.0,
)
