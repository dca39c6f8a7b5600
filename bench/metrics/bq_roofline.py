"""K1 and K2's share of their byte bound over a training step: the bytes the
step's calls must move (frozen ``bq_step_calls``/``bq_cost``) at the card's
HBM peak, over the K1/K2 kernels' device time.  Silent where the traced
steps do not launch exactly those calls."""
from bench.harness.kernels import names
from bench.yardstick import costs


def read(t):
    peak = costs.peaks(t.device_kind)
    if t.traffic["kind"] != "train" or not t.units or peak is None:
        return None
    calls = costs.bq_step_calls(t.cfg, t.traffic["movement"])
    group = names("bq")
    if not calls or t.kernel_count(group) != len(calls) * len(t.units):
        return None
    bound_s = sum(costs.bq_cost(kind, n, fb)[1] for kind, n, fb in calls) / peak["hbm_bytes_per_s"]
    return 100.0 * bound_s * len(t.units) / (t.kernel_ms(group) / 1e3)
