"""Share of the traced window of a ``decode_sessions`` cell in which no operation ran on
the device: 1 - busy / window, in percent."""


def read(t):
    if t.traffic["kind"] != "decode_sessions" or not t.window_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
