"""Prefill attention's share of its FLOP bound: the traced prefills' kept
(q, k) pairs (frozen ``k3_cost``) at the card's bf16 peak, over the device
time of the kernels launched under the model's ``attention.forward`` ranges,
whichever kernels do the work.  The batches' decode steps open
``attention.decode`` and are left out by name.  Silent where the range is
missing, or where the slice's device time with no launch in the trace
(which no range can hold) is 1 % of the range's time or more: a kernel of
the range whose launch the trace lost would raise the share, past 100 %
where that kernel is the attention itself."""
from bench.yardstick import costs


def read(t):
    peak = costs.peaks(t.device_kind)
    if t.traffic["kind"] != "serve_batches" or not t.units or peak is None:
        return None
    ms = t.op_ms.get("attention.forward")
    if not ms or sum(t.unattributed.values()) >= 0.01 * ms:
        return None
    h, kvh, d, window = costs.attention_shape(t.cfg)
    flop = sum(costs.k3_cost(b=u["batch"], sq=u["prompt_len"], skv=u["prompt_len"], h=h, kvh=kvh,
                             d=d, causal=True, window=window)[0] for u in t.units)
    return 100.0 * flop * t.cfg["num_hidden_layers"] / peak["bf16_flop_per_s"] / (ms / 1e3)
