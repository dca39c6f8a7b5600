"""Kernel launches a decode step (copies and fills apart), from the trace:
the host's dispatch work the step asks for."""


def read(t):
    if t.traffic["kind"] != "decode_sessions" or not t.units:
        return None
    return t.launches / len(t.units)
