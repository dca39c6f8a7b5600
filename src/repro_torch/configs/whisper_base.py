"""whisper-base [audio] — 6L d_model=512 8H (kv=8) d_ff=2048 vocab=51865 —
encoder-decoder with conv frontend (STUB).  [arXiv:2212.04356; unverified]

Per the assignment the conv frontend is a stub: ``input_specs()`` provides
precomputed frame embeddings (seq_len x d_model) to the encoder.  The decoder
has self-attention (causal, cached) + cross-attention to encoder states
(cached at prefill).  Sinusoidal positions, MHA, no rope.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    source="[arXiv:2212.04356; unverified]",
    num_layers=6,  # == enc_layers == dec_layers
    enc_layers=6,
    dec_layers=6,
    d_model=512,
    num_heads=8,
    num_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51_865,
    attn_kind="full",
    pos_embed="sinusoidal",
    frontend="audio_stub",
    tie_embeddings=True,
)
