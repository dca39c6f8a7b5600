"""Model/arch configuration system (the port's copy of ``repro.configs.base``).

Every assigned architecture is a ``ModelConfig`` instance in its own module
(``src/repro_torch/configs/<id>.py``); the registry in ``__init__`` exposes
them by ``--arch <id>``.  ``reduced()`` derives the small same-family config
used by the CPU parity tests.  The fields and values are held equal to the JAX
package's by ``tests/test_torch_models.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple


@dataclass(frozen=True)
class ShapeCell:
    """One assigned input-shape cell (seq_len x global_batch)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


# The four assigned LM shape cells.  ``decode_*``/``long_*`` lower
# ``serve_step`` (one new token against a KV cache of seq_len), not
# ``train_step``.
SHAPE_CELLS: Tuple[ShapeCell, ...] = (
    ShapeCell("train_4k", 4_096, 256, "train"),
    ShapeCell("prefill_32k", 32_768, 32, "prefill"),
    ShapeCell("decode_32k", 32_768, 128, "decode"),
    ShapeCell("long_500k", 524_288, 1, "decode"),
)

SHAPES = {c.name: c for c in SHAPE_CELLS}


@dataclass(frozen=True)
class ModelConfig:
    # identity -----------------------------------------------------------
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""  # provenance note "[arXiv:...; tier]"

    # trunk --------------------------------------------------------------
    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # attention ----------------------------------------------------------
    attn_kind: str = "full"  # full | swa | mla | none
    window: int = 0  # sliding-window size when attn_kind == "swa"
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    pos_embed: str = "rope"  # rope | sinusoidal (whisper)

    # MLA (deepseek) -----------------------------------------------------
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0

    # MoE ----------------------------------------------------------------
    num_experts: int = 0
    num_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # leading layers that stay dense
    capacity_factor: float = 1.25
    moe_group_size: int = 4_096  # tokens per dispatch group (memory bound)

    # SSM (mamba1/2) -----------------------------------------------------
    ssm_version: int = 0  # 0 = none, 1 = mamba1, 2 = mamba2
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64  # mamba2 head size P
    dt_rank: int = 0  # mamba1 dt projection rank
    ssm_algo: str = "scan"  # mamba2 seq mixer: "scan" (elementwise assoc-scan)
    #                         or "ssd" (matmul/SSD form — MXU-friendly, §Perf B)

    # hybrid (zamba2): one *shared* attention+MLP block applied every
    # ``attn_every`` SSM blocks, with small per-invocation LoRA adapters.
    attn_every: int = 0
    shared_lora_rank: int = 0

    # enc-dec (whisper) ---------------------------------------------------
    enc_layers: int = 0
    dec_layers: int = 0

    # modality frontends are STUBS per assignment: input_specs() provides
    # precomputed patch/frame embeddings of width d_model.
    frontend: str = ""  # "" | "vit_stub" | "audio_stub"
    num_prefix_tokens: int = 0  # vision tokens prepended to the text stream

    # numerics / training --------------------------------------------------
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    schedule: str = "cosine"  # "wsd" for minicpm
    remat: str = "dots"  # nothing | dots | full
    attn_chunk: int = 1_024  # query-chunked attention block (memory bound)

    # ----------------------------------------------------------------- api
    @property
    def is_encdec(self) -> bool:
        return self.family == "audio" and self.enc_layers > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_version == 2 else 0

    def supports_long_context(self) -> bool:
        """Whether the ``long_500k`` cell applies (sub-quadratic attention)."""
        if self.family in ("ssm", "hybrid"):
            return True
        return self.attn_kind == "swa"

    def live_cells(self) -> Tuple[ShapeCell, ...]:
        """The shape cells that are live for this arch (spec-mandated skips)."""
        cells = []
        for c in SHAPE_CELLS:
            if c.name == "long_500k" and not self.supports_long_context():
                continue
            cells.append(c)
        return tuple(cells)

    def reduced(self) -> "ModelConfig":
        """Small same-family config for CPU smoke tests."""

        def shrink(v, lo, div):
            return max(lo, v // div) if v else 0

        kw = dict(
            name=self.name + "-reduced",
            num_layers=min(self.num_layers, 2) if self.num_layers else 0,
            d_model=64,
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            head_dim=16 if self.num_heads else 0,
            d_ff=128 if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 256),
            window=min(self.window, 16) if self.window else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_dim=16 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            num_experts=min(self.num_experts, 4),
            num_shared_experts=min(self.num_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            moe_group_size=64,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_version == 2 else self.ssm_head_dim,
            dt_rank=shrink(self.dt_rank, 4, 64),
            attn_every=min(self.attn_every, 2) if self.attn_every else 0,
            shared_lora_rank=min(self.shared_lora_rank, 4),
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            dec_layers=min(self.dec_layers, 2) if self.dec_layers else 0,
            num_prefix_tokens=min(self.num_prefix_tokens, 4),
            attn_chunk=32,
        )
        # keep kv heads dividing heads
        if kw["num_heads"]:
            while kw["num_heads"] % max(kw["num_kv_heads"], 1):
                kw["num_kv_heads"] += 1
        return replace(self, **kw)

    def param_count(self) -> int:
        """Parameter count N (for MODEL_FLOPS = 6*N*D), from the port's own
        spec trees; raises NotImplementedError for families not ported yet."""
        from repro_torch.models import model as _m

        return _m.param_count(self)

    def active_param_count(self) -> int:
        from repro_torch.models import model as _m

        return _m.param_count(self, active_only=True)


def validate(cfg: ModelConfig) -> None:
    if cfg.num_heads and cfg.num_kv_heads:
        assert cfg.num_heads % cfg.num_kv_heads == 0, (
            f"{cfg.name}: heads {cfg.num_heads} % kv {cfg.num_kv_heads}"
        )
    if cfg.family == "moe":
        assert cfg.num_experts > 0 and cfg.top_k > 0
    if cfg.family in ("ssm", "hybrid"):
        assert cfg.ssm_version in (1, 2)
    if cfg.attn_kind == "swa":
        assert cfg.window > 0
    if cfg.attn_kind == "mla":
        assert cfg.kv_lora_rank > 0
