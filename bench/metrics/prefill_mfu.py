"""The whole prefill's share of the card's bf16 peak: the frozen
``prefill_flop`` of the traced batches (weights, the last position's head,
attention's kept pairs) over their time to first token on the host."""
from bench.yardstick import costs


def read(t):
    peak = costs.peaks(t.device_kind)
    if t.traffic["kind"] != "serve_batches" or not t.units or peak is None:
        return None
    flop = sum(costs.prefill_flop(t.cfg, u["batch"], u["prompt_len"]) for u in t.units)
    return 100.0 * flop / sum(u["ttft_s"] for u in t.units) / peak["bf16_flop_per_s"]
