"""Named ranges of the model layer, for the profiler.

Attention's core (from q, k and v after rope to the output before ``wo``)
runs in one range named by its phase: ``attention.forward`` at prefill and in
the training forward (a layer's recompute in backward opens it again: that is
attention work too), ``attention.decode`` in the decode step, and
``attention.backward`` round the same core's backward on autograd's thread.
The backward range is opened and closed by two identity autograd functions
around the core: the one on the output opens it in its backward, the one on
q, k and v closes it.  They save no tensors, so a rematerialised layer
recomputes the same saved tensors with them or without.

The ranges are ``torch.profiler.record_function`` events, on the profiler's
clock beside the device's.  When no profiler is recording, :func:`span` and
:func:`attention_core` cost one check: they open no range and put no node in
the autograd graph (an idle ``record_function`` costs 8-11 us a call on
the host, the check ~0.1 us).
"""
from __future__ import annotations

import contextlib

import torch
from torch.profiler import record_function

_OFF = contextlib.nullcontext()
recording = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``record_function`` range named ``name`` while a profiler records,
    else a context that does nothing."""
    return record_function(name) if recording() else _OFF


class _Range:
    """A range opened on one autograd node and closed on another."""

    def __init__(self, name: str):
        self.name, self.rf = name, None

    def open(self):
        self.rf = record_function(self.name)
        self.rf.__enter__()

    def close(self):
        self.rf.__exit__(None, None, None)
        self.rf = None


class _OpenInBackward(torch.autograd.Function):
    """Identity on the core's output; its backward opens the range."""

    @staticmethod
    def forward(ctx, rng, o):
        ctx.rng = rng
        return o.view_as(o)

    @staticmethod
    def backward(ctx, grad):
        ctx.rng.open()
        return None, grad


class _CloseInBackward(torch.autograd.Function):
    """Identity on the core's inputs; its backward closes the range."""

    @staticmethod
    def forward(ctx, rng, *xs):
        ctx.rng = rng
        return tuple(x.view_as(x) for x in xs)

    @staticmethod
    def backward(ctx, *grads):
        ctx.rng.close()
        return (None, *grads)


def attention_core(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, **kw) -> torch.Tensor:
    """``fn(q, k, v, **kw)`` in the range ``attention.forward``, and its
    backward in ``attention.backward``, while a profiler records."""
    if not recording():
        return fn(q, k, v, **kw)
    if not (torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad)):
        with record_function("attention.forward"):
            return fn(q, k, v, **kw)
    rng = _Range("attention.backward")
    q, k, v = _CloseInBackward.apply(rng, q, k, v)
    with record_function("attention.forward"):
        o = fn(q, k, v, **kw)
    return _OpenInBackward.apply(rng, o)
