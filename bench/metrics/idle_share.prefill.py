"""Share of the prefills' time in which no operation ran on the device, in
percent: over the ``bench.prefill`` ranges of a ``serve_batches`` cell's
traced batches (each from the batch's issue to its first token on the host,
the time a request's TTFT pays for; the decode steps after it are left
out), 1 - busy / span."""


def read(t):
    if t.traffic["kind"] != "serve_batches":
        return None
    busy, span = t.busy_in("bench.prefill")
    if not span:
        return None
    return 100.0 * (1.0 - busy / span)
