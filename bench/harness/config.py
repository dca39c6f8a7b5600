"""A configuration file of the benchmark, read: its parameter layout, which
the benchmark owns, and the port's ``ModelConfig`` built from it.

The file holds the published configuration's keys (Hugging Face names) as
they are run.  The benchmark draws the weights itself in this layout and
hands the same tensors to the port and to the reference; the layout is
checked against the port's own parameter specs before a run, so that a port
that lays its parameters out otherwise stops the run instead of being fed
weights under the wrong names.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Dict, Tuple

BENCH = Path(__file__).resolve().parents[1]


def load(name: str) -> dict:
    """The configuration file ``bench/configs/<name>.json``."""
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def head_dim(cfg: dict) -> int:
    return cfg["hidden_size"] // cfg["num_attention_heads"]


def param_shapes(cfg: dict) -> Dict[str, Tuple[int, ...]]:
    """Path -> shape of every parameter of the dense decoder the file
    describes; the layers' tensors are stacked on a leading axis."""
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    n, h, kvh, dh = (cfg["num_hidden_layers"], cfg["num_attention_heads"],
                     cfg["num_key_value_heads"], head_dim(cfg))
    shapes = {
        "embed": (v, d),
        "ln_f": (d,),
        "seg0/ln1": (n, d),
        "seg0/ln2": (n, d),
        "seg0/attn/wq": (n, d, h * dh),
        "seg0/attn/wk": (n, d, kvh * dh),
        "seg0/attn/wv": (n, d, kvh * dh),
        "seg0/attn/wo": (n, h * dh, d),
        "seg0/ffn/w_gate": (n, d, f),
        "seg0/ffn/w_up": (n, d, f),
        "seg0/ffn/w_down": (n, f, d),
    }
    if not cfg["tie_word_embeddings"]:
        shapes["lm_head"] = (d, v)
    return dict(sorted(shapes.items()))


def is_norm(path: str) -> bool:
    return path.rsplit("/", 1)[-1] in ("ln1", "ln2", "ln_f")


def foldable(shape) -> bool:
    """DaeMon's int8 gradient link: ndim >= 2, last dim a multiple of 128."""
    return len(shape) >= 2 and shape[-1] % 128 == 0


def page_class(shape) -> bool:
    """DaeMon's page class: stacked (ndim >= 3), last dim a multiple of 128."""
    return len(shape) >= 3 and shape[-1] % 128 == 0


def program_config(cfg: dict):
    """The port's ``ModelConfig`` for the file: its registry entry with every
    size the file states put in."""
    from repro_torch.configs import get_config

    window = cfg.get("sliding_window") or 0
    out = dataclasses.replace(
        get_config(cfg["program_arch"]),
        num_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        num_heads=cfg["num_attention_heads"], num_kv_heads=cfg["num_key_value_heads"],
        head_dim=head_dim(cfg), d_ff=cfg["intermediate_size"], vocab_size=cfg["vocab_size"],
        attn_kind="swa" if window else "full", window=window, rope_theta=cfg["rope_theta"],
        norm_eps=cfg["rms_norm_eps"], tie_embeddings=cfg["tie_word_embeddings"],
    )
    check_layout(cfg, out)
    return out


def check_layout(cfg: dict, pcfg) -> None:
    """Raise unless the port's parameter specs are this layout, path for path."""
    from repro_torch.models import model as M

    def flat(tree, prefix=""):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out.update(flat(v, f"{prefix}{k}/"))
            else:
                out[prefix + k] = tuple(v.shape)
        return out

    theirs, ours = flat(M.model_specs(pcfg)), param_shapes(cfg)
    if theirs != ours:
        raise RuntimeError(f"the port lays out {cfg['name']}'s parameters as {theirs}, "
                           f"the benchmark as {ours}")


def to_tree(flat: Dict[str, object]) -> dict:
    """Nested dicts, as the port takes its parameters, from path -> tensor."""
    tree: dict = {}
    for path, x in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = x
    return tree


def flatten(tree, prefix: str = "") -> Dict[str, object]:
    """path -> leaf of nested dicts (the inverse of :func:`to_tree`)."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(flatten(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out
