"""K3's share of its FLOP bound over the traced prefills: attention's kept
pairs (frozen ``k3_cost``) at the card's bf16 peak, over the K3 kernels'
device time.  Silent where the traced prefills do not launch K3 once a
layer."""
from bench.harness.kernels import names
from bench.yardstick import costs


def read(t):
    peak = costs.peaks(t.device_kind)
    if t.traffic["kind"] != "serve_batches" or not t.units or peak is None:
        return None
    group, layers = names("k3"), t.cfg["num_hidden_layers"]
    if t.kernel_count(group) != layers * len(t.units):
        return None
    h, kvh, d, window = costs.attention_shape(t.cfg)
    flop = sum(costs.k3_cost(b=u["batch"], sq=u["prompt_len"], skv=u["prompt_len"], h=h, kvh=kvh,
                             d=d, causal=True, window=window)[0] for u in t.units) * layers
    return 100.0 * flop / peak["bf16_flop_per_s"] / (t.kernel_ms(group) / 1e3)
