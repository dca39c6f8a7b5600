"""Device ms of training attention's products and softmax a step: the
kernels of ``aten::bmm`` (the score and value products, forward, recompute
and backward), ``aten::_softmax`` and ``aten::_softmax_backward_data``."""
OPS = ("aten::bmm", "aten::_softmax", "aten::_softmax_backward_data")


def read(t):
    if t.traffic["kind"] != "train" or not t.units or "aten::bmm" not in t.op_ms:
        return None
    return sum(t.op_ms.get(op, 0.0) for op in OPS) / len(t.units)
