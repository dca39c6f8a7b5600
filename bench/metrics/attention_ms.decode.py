"""Device ms of decode attention a step: the kernels launched under the
model's ``attention.decode`` ranges (one a layer: the cache's reads and casts,
the products, mask and softmax), per traced decode step.  Silent where the
range is missing, or where the slice's device time with no launch in the
trace (which no range can hold) is 1 % of the range's time or more: the
reading could then be that far short."""


def read(t):
    if t.traffic["kind"] != "decode_sessions" or not t.units:
        return None
    ms = t.op_ms.get("attention.decode")
    if not ms or sum(t.unattributed.values()) >= 0.01 * ms:
        return None
    return ms / len(t.units)
