"""Compressed, async checkpointing with atomic publish (port of
``repro.checkpoint.ckpt``), in the JAX package's on-disk format, so that each
side restores the other's checkpoints.

Layout (one directory per step):

    <dir>/step_00000100/
        manifest.json          step, arrays {key -> shape, dtype}, extra, time,
                               and the sha256 ``hash`` of the payload
        arrays/shard_0.npz.zst zstandard-compressed npz of every array

Keys are JAX's path strings joined by "/": a dict key prints bare, a tuple
index as its number, a NamedTuple field with a leading dot, so the Adam first
moment of ``embed`` in ``(params, DaemonState)`` is ``1/.adam/.m/embed``.

A bfloat16 tensor is stored as ``np.savez`` stores JAX's ``ml_dtypes`` array:
its 16-bit patterns as numpy void ``V2``, with manifest dtype "bfloat16".
Restoring views such an array as ``torch.bfloat16`` again.  (JAX's own
restore hands these leaves back as void arrays, which its train step cannot
take, so JAX cannot resume a ``movement="daemon"`` run; the port reads the
manifest's dtype and can.)

Atomicity: written to ``step_X.tmp`` then ``os.rename``d, so a crashed writer
never corrupts the latest checkpoint.  ``save_async`` copies every leaf to
host memory on the caller's thread, which decouples the checkpoint from the
train step (the port's step updates the master and the moments in place),
then serialises, compresses and writes on a background thread; ``wait``
re-raises that thread's error.  ``restore`` places each leaf on the device
and dtype of the matching leaf of ``like``.

On a mesh (a process group of several ranks, leaves as DTensors) the format
is the same global arrays: ``save``/``save_async`` gather each sharded leaf
on the calling thread, on every rank (a collective they all enter); only
rank 0 writes, and every rank passes a barrier once the step is published
(in ``save``, or in the ``wait`` that follows ``save_async``).
``restore(..., shardings=)`` lays each global array out by its sharding
(``runtime.sharding.NamedSharding``): that is the elastic re-shard, a run
saved on one mesh resuming on another.  ``zstandard`` is optional:
without it, a save or a restore raises ``ImportError`` before it touches the
filesystem, never at import.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.models.nn import is_dtensor
from repro_torch.runtime.sharding import place, place_as, to_global

try:
    import zstandard
except ImportError:  # optional dep: fail at first (de)compress, not import
    zstandard = None

_FLAT_SEP = "/"
_BF16_STORED = np.dtype("V2")  # what np.savez makes of an ml_dtypes bfloat16 array


def _is_namedtuple(tree: Any) -> bool:
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _children(tree: Any) -> Optional[List[Tuple[str, Any]]]:
    """(key part, child) pairs of a container in JAX's flattening order:
    sorted dict keys, NamedTuple fields (".name"), sequence indices; None for
    a leaf."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (tuple, list)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return None


def _items(tree: Any, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in JAX's order; None is an empty subtree, as in JAX."""
    children = _children(tree)
    if children is None:
        if tree is not None:
            yield _FLAT_SEP.join(path), tree
        return
    for part, child in children:
        yield from _items(child, path + (part,))


def _host(leaf: Any) -> np.ndarray:
    """A host copy of one leaf (never a view: the caller may write the leaf
    in place afterwards), the whole of a DTensor; bfloat16 as its bit
    patterns in ``V2``."""
    if isinstance(leaf, torch.Tensor):
        leaf = to_global(leaf.detach())
    t = torch.as_tensor(leaf).detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy().view(_BF16_STORED)
    return t.numpy()


def flatten(tree: Any) -> Dict[str, np.ndarray]:
    """Host copies of every leaf, under JAX's keys."""
    return {key: _host(leaf) for key, leaf in _items(tree)}


def dtype_name(a: np.ndarray) -> str:
    """The manifest's dtype of a flattened array, as JAX writes it."""
    return "bfloat16" if a.dtype == _BF16_STORED else str(a.dtype)


def serialize(flat: Dict[str, np.ndarray]) -> bytes:
    """The uncompressed payload: an npz of every array."""
    buf = io.BytesIO()
    np.savez(buf, **flat)
    return buf.getvalue()


def deserialize(payload: bytes) -> Dict[str, np.ndarray]:
    with np.load(io.BytesIO(payload)) as z:
        return {k: z[k] for k in z.files}


def _tensor(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        if a.dtype != _BF16_STORED:
            raise ValueError(f"a bfloat16 array stored as {a.dtype}, not as 16-bit patterns")
        return torch.from_numpy(np.asarray(a, order="C").view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.asarray(a, order="C"))


def _rank0() -> bool:
    return not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def unflatten_into(like: Any, flat: Dict[str, np.ndarray], dtypes: Dict[str, str],
                   shardings: Any = None) -> Any:
    """A tree of ``like``'s structure holding the arrays of ``flat`` (manifest
    dtypes ``dtypes``), each on the device and in the dtype of ``like``'s
    leaf at the same key, and laid out by ``shardings`` (a tree of
    ``like``'s structure; a ``None`` leaf or subtree keeps the array whole),
    else as ``like``'s leaf if that is a DTensor."""

    def build(t: Any, sh: Any, path: Tuple[str, ...]) -> Any:
        children = _children(t)
        if children is not None:
            sh_children = [None] * len(children) if sh is None else [c for _, c in _children(sh)]
            built = [build(child, c_sh, path + (part,))
                     for (part, child), c_sh in zip(children, sh_children)]
            if isinstance(t, dict):
                return dict(zip(sorted(t), built))
            return type(t)(*built) if _is_namedtuple(t) else type(t)(built)
        if t is None:
            return None
        key = _FLAT_SEP.join(path)
        if key not in flat:
            raise KeyError(f"checkpoint missing array {key!r}")
        v = flat[key]
        if tuple(v.shape) != tuple(t.shape):
            raise ValueError(f"{key}: checkpoint shape {v.shape} != expected {tuple(t.shape)}")
        x = _tensor(v, dtypes[key]).to(device=t.device, dtype=t.dtype)
        if sh is not None:
            return place(x, sh)
        if isinstance(t, torch.Tensor) and is_dtensor(t):
            return place_as(x, t.device_mesh, t.placements)
        return x

    return build(like, shardings, ())


class CheckpointManager:
    def __init__(self, directory: str | Path, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pending = False  # a save_async whose barrier wait() still owes

    # ---------------- save ----------------
    def _write(self, step: int, flat: Dict[str, np.ndarray], extra: Dict) -> Path:
        if zstandard is None:  # before any filesystem mutation
            raise ImportError("checkpoint save requires the 'zstandard' package")
        final = self.dir / f"step_{step:08d}"
        tmp = self.dir / f"step_{step:08d}.tmp"
        if tmp.exists():
            shutil.rmtree(tmp)
        (tmp / "arrays").mkdir(parents=True)
        manifest = {"step": step, "arrays": {}, "extra": extra, "time": time.time()}
        payload = zstandard.ZstdCompressor(level=3).compress(serialize(flat))
        (tmp / "arrays" / "shard_0.npz.zst").write_bytes(payload)
        for k, v in flat.items():
            manifest["arrays"][k] = {"shape": list(v.shape), "dtype": dtype_name(v)}
        manifest["hash"] = hashlib.sha256(payload).hexdigest()
        (tmp / "manifest.json").write_text(json.dumps(manifest, indent=1))
        if final.exists():
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:08d}", ignore_errors=True)

    def save(self, step: int, tree: Any, extra: Optional[Dict] = None) -> Path:
        flat = flatten(tree)
        final = self.dir / f"step_{step:08d}"
        try:
            if _rank0():
                final = self._write(step, flat, extra or {})
        finally:
            _barrier()
        return final

    def save_async(self, step: int, tree: Any, extra: Optional[Dict] = None) -> None:
        """Snapshot to host now; compress+write on a background thread (rank
        0's; the others only gather)."""
        self.wait()
        flat = flatten(tree)  # host copy (decouples from in-place updates)
        self._pending = True
        if not _rank0():
            return

        def work():
            try:
                self._write(step, flat, extra or {})
            except BaseException as e:  # surfaced by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._pending:
            self._pending = False
            _barrier()
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ---------------- restore ----------------
    def all_steps(self) -> List[int]:
        return sorted(
            int(p.name.split("_")[1])
            for p in self.dir.glob("step_*")
            if p.is_dir() and not p.name.endswith(".tmp")
        )

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int], like: Any, *,
                shardings: Any = None) -> Tuple[Any, Dict]:
        """Restore into the structure of ``like``: each leaf on the device
        and in the dtype of ``like``'s leaf at the same key, laid out by
        ``shardings`` if given (the elastic re-shard: the stored global
        arrays are laid out for whatever mesh the caller runs now)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = self.dir / f"step_{step:08d}"
        manifest = json.loads((d / "manifest.json").read_text())
        payload = (d / "arrays" / "shard_0.npz.zst").read_bytes()
        if hashlib.sha256(payload).hexdigest() != manifest["hash"]:
            raise IOError(f"checkpoint {d} corrupt: hash mismatch")
        if zstandard is None:
            raise ImportError("checkpoint load requires the 'zstandard' package")
        flat = deserialize(zstandard.ZstdDecompressor().decompress(payload))
        dtypes = {k: a["dtype"] for k, a in manifest["arrays"].items()}
        return unflatten_into(like, flat, dtypes, shardings), manifest["extra"]
