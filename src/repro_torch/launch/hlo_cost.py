"""Per-device op counter (the port's counterpart of ``repro.launch.hlo_cost``).

There is no HLO here.  JAX's module re-derives FLOPs, HBM bytes and
collective bytes from the text of the compiled, partitioned module.  The
port runs the step eagerly on fake tensors (``launch/dryrun.py``) and counts
the aten ops that one rank dispatches, so every shape is per-device, as in
the partitioned module:

    flops            matmul-family ops (mm, addmm, bmm, baddbmm, convolution)
                     by ``torch.utils.flop_counter``'s formulas (these are
                     also ``dot_flops``); 1 a result element for pointwise
                     ops; input bytes / 4 for reductions (softmax counts as
                     one); a skipped kernel launch its ``cost()`` FLOP
    hbm_bytes        operand + result bytes of every op that is not a view
                     or metadata op (``ZERO_BYTES``); a kernel launch its
                     ``cost()`` bytes.  Eager's model: a kernel an op and no
                     fusion, so it is an upper bound on JAX's fused count
    collective bytes the per-device operand bytes of the collectives that
                     DTensor's redistributions (``_c10d_functional``) and
                     ``core/movement/collectives.py`` (``c10d``) issue, in
                     JAX's five kinds

It adds ``dot_flops``, ``kernel_launches`` (the launches a dry run skipped,
reported by the kernel wrappers through ``kernels.runtime.dry_launch``) and
``peak_live_bytes``, the most bytes of storage made during the call and
alive at once (the arguments' own storage not counted).

A DTensor op is counted through the ops it runs on the local shards and the
collectives of its redistributions; the global-shape ops DTensor runs on fake
tensors to propagate shapes are not counted.
"""
from __future__ import annotations

import sys
import weakref
from collections import Counter
from typing import Any, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import runtime

ZERO_BYTES = {
    "aten.view", "aten._unsafe_view", "aten.expand", "aten.permute", "aten.transpose",
    "aten.t", "aten.slice", "aten.select", "aten.unsqueeze", "aten.squeeze",
    "aten.as_strided", "aten.alias", "aten.detach", "aten.empty", "aten.empty_strided",
    "aten.empty_like", "aten.split", "aten.split_with_sizes", "aten.unbind",
    "aten.lift_fresh", "_c10d_functional.wait_tensor",
}
REDUCTIONS = {
    "aten.sum", "aten.mean", "aten.amax", "aten.amin", "aten.max", "aten.min", "aten.prod",
    "aten.argmax", "aten.argmin", "aten.logsumexp", "aten.norm", "aten.linalg_vector_norm",
    "aten.var", "aten.var_mean", "aten.std", "aten.any", "aten.all", "aten.cumsum",
    "aten._softmax", "aten._log_softmax", "aten._softmax_backward_data",
    "aten._log_softmax_backward_data",
}
CONVERTS = {"aten._to_copy"}  # XLA's ``convert``, which JAX counts as elementwise
# op -> (JAX's kind, the argument that holds the operand)
COLLECTIVES = {
    "_c10d_functional.all_gather_into_tensor": ("all-gather", 0),
    "_c10d_functional.all_gather_into_tensor_coalesced": ("all-gather", 0),
    "_c10d_functional.all_reduce": ("all-reduce", 0),
    "_c10d_functional.all_reduce_": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced": ("all-reduce", 0),
    "_c10d_functional.all_reduce_coalesced_": ("all-reduce", 0),
    "_c10d_functional.reduce_scatter_tensor": ("reduce-scatter", 0),
    "_c10d_functional.reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "_c10d_functional.all_to_all_single": ("all-to-all", 0),
    "c10d.allreduce_": ("all-reduce", 0),
    "c10d.allgather_": ("all-gather", 1),
    "c10d._allgather_base_": ("all-gather", 1),
    "c10d.allgather_into_tensor_coalesced_": ("all-gather", 1),
    "c10d.reduce_scatter_": ("reduce-scatter", 1),
    "c10d._reduce_scatter_base_": ("reduce-scatter", 1),
    "c10d.reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "c10d.alltoall_base_": ("all-to-all", 1),
    "c10d.alltoall_": ("all-to-all", 1),
    "c10d.send": ("collective-permute", 0),
    "c10d.recv_": ("collective-permute", 0),
}


def _tensors(tree) -> list:
    """The tensors in ``tree`` (nested lists, tuples, dicts, named tuples);
    a DTensor's local shard in its place."""
    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor):
            out.append(getattr(x, "_local_tensor", x))
    return out


def local_bytes(tree) -> int:
    """The bytes of the tensors in ``tree``; of a DTensor, its local shard's."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


class OpCounter(TorchDispatchMode):
    """Count the ops dispatched while it is active (see the module's
    docstring).  ``analyze(fn, *args, **kw)`` runs ``fn`` under it and
    returns the counts; ``output`` then holds what ``fn`` returned."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.dot_flops = 0.0
        self.hbm_bytes = 0.0
        self.collective_bytes: Counter = Counter()
        self.collective_counts: Counter = Counter()
        self.kernel_launches: Counter = Counter()
        self._live: Dict[int, int] = {}
        self._known: set = set()
        self._live_bytes = 0
        self.peak_live_bytes = 0
        self._shadow = 0
        self._unpatch = None
        self.output = None

    # ------------------------------------------------------------------
    def analyze(self, fn, *args, **kwargs) -> Dict[str, Any]:
        self._known.update(_storage_key(t) for t in _tensors((args, kwargs)))
        with self:
            self.output = fn(*args, **kwargs)
        return self.counts()

    def counts(self) -> Dict[str, Any]:
        return {
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "collective_bytes": dict(self.collective_bytes),
            "collective_counts": dict(self.collective_counts),
            "dot_flops": self.dot_flops,
            "kernel_launches": dict(self.kernel_launches),
            "peak_live_bytes": self.peak_live_bytes,
        }

    def kernel(self, name: str, flops: float, n_bytes: float) -> None:
        """A kernel launch a dry run skipped (``kernels.runtime.dry_launch``)."""
        self.flops += flops
        self.hbm_bytes += n_bytes
        self.kernel_launches[name] += 1

    # ------------------------------------------------------------------
    def __enter__(self):
        self._patch_sharding_propagation()
        runtime.COUNTERS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        runtime.COUNTERS.remove(self)
        if self._unpatch is not None:
            self._unpatch()
            self._unpatch = None
        return super().__exit__(*exc)

    def _patch_sharding_propagation(self) -> None:
        """Mark the ops DTensor runs on global shapes to propagate them, so
        they are not counted (they are not the rank's work)."""
        if "torch.distributed.tensor" not in sys.modules:
            return  # no DTensor can exist yet
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name, None)
        if orig is None:
            raise RuntimeError(f"this torch's ShardingPropagator has no {name}: the op "
                               "counter cannot tell DTensor's shape propagation from work")

        def shadowed(prop, *args, **kwargs):
            self._shadow += 1
            try:
                return orig(prop, *args, **kwargs)
            finally:
                self._shadow -= 1

        setattr(ShardingPropagator, name, shadowed)
        self._unpatch = lambda: setattr(ShardingPropagator, name, orig)

    def _free(self, key: int) -> None:
        self._live_bytes -= self._live.pop(key, 0)

    def _track(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            key = st._cdata
            if key in self._live or key in self._known:
                continue
            self._live[key] = st.nbytes()
            self._live_bytes += st.nbytes()
            weakref.finalize(st, self._free, key)
        self.peak_live_bytes = max(self.peak_live_bytes, self._live_bytes)

    # ------------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = sys.modules.get("torch.distributed.tensor")
        if dtensor is not None and any(issubclass(t, dtensor.DTensor) for t in types):
            return NotImplemented  # DTensor runs it as local ops, counted one by one
        out = func(*args, **kwargs)
        if self._shadow:
            return out
        self._track(out)
        packet = func._overloadpacket
        name = str(packet)
        if func.namespace == "prim" or name in ZERO_BYTES or func.is_view:
            return out
        self.hbm_bytes += local_bytes((args, kwargs)) + local_bytes(out)
        if packet in flop_registry:
            f = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops += f
            self.dot_flops += f
        elif name in COLLECTIVES:
            kind, i = COLLECTIVES[name]
            self.collective_bytes[kind] += local_bytes(args[i])
            self.collective_counts[kind] += 1
        elif name in REDUCTIONS:
            self.flops += local_bytes(args[0]) / 4.0
        elif torch.Tag.pointwise in func.tags or name in CONVERTS:
            self.flops += sum(t.numel() for t in _tensors(out))
        return out
