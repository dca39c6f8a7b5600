"""Device ms of training attention a step: the kernels launched under the
model's ranges ``attention.forward`` (the forward, and each rematerialised
layer's recompute in backward) and ``attention.backward``, per traced step:
whatever kernels do the attention core, its casts, masks and repeated K/V
included.  Silent where a range is missing, or where the slice's device time
with no launch in the trace (which no range can hold) is 1 % of the ranges'
time or more: the reading could then be that far short."""
RANGES = ("attention.forward", "attention.backward")


def read(t):
    if t.traffic["kind"] != "train" or not t.units or not all(r in t.op_ms for r in RANGES):
        return None
    ms = sum(t.op_ms[r] for r in RANGES)
    if sum(t.unattributed.values()) >= 0.01 * ms:
        return None
    return ms / len(t.units)
