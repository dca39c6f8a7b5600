"""The whole training step's share of the card's bf16 peak: the frozen
``train_flop`` of the traced steps over their host-clock time (each step
ends on the host reading its loss)."""
from bench.yardstick import costs


def read(t):
    peak = costs.peaks(t.device_kind)
    if t.traffic["kind"] != "train" or not t.units or peak is None:
        return None
    flop = costs.train_flop(t.cfg, t.traffic["batch"], t.traffic["seq"]) * len(t.units)
    return 100.0 * flop / sum(u["wall_s"] for u in t.units) / peak["bf16_flop_per_s"]
