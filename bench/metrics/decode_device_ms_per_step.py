"""Device busy ms a decode step: the union of the device's operations over
the traced decode steps, per step."""


def read(t):
    if t.traffic["kind"] != "decode_sessions" or not t.units:
        return None
    return 1e3 * t.busy_s / len(t.units)
