"""Checkpointing with an async flush — the port of the JAX package's
``checkpoint/checkpoint.py``, writing its file format.

A checkpoint is one ``ckpt_{step:08d}.npz`` a step in a directory, plus a
``manifest.json`` holding ``{"latest_step": step}``: the tree's leaves as
host arrays under keys joined by ``/`` (``{"a": {"b": x}}`` -> ``"a/b"``), a
port ``core.stencil.WeightField`` under its key with ``%wf`` appended.
Writes go to ``<file>.tmp.npz`` and then ``os.replace``, so a crash mid-write
never corrupts the latest checkpoint; the newest ``keep`` files stay.  A
file the JAX package's ``Checkpointer`` wrote restores here, and the other
way round.

Where the JAX package's arrays are immutable, the port's train state is
updated in place (``optim.adamw.apply_update``), so ``save`` takes host
copies of every leaf on the caller's thread before it returns (on the CPU
``Tensor.numpy()`` is a view, not a copy); only the write runs on the
writer thread.  A bf16 leaf is stored as float32, which holds it exactly
(numpy has no bf16).  ``restore(step, into=state)`` copies the checkpoint
into the tensors of ``state`` (``Tensor.copy_``), so a train state keeps
sharing its storage with the model it trains; a key or shape that differs
from the checkpoint's raises, naming the first.  Where the JAX package
takes shardings, the port takes the device to put the leaves on: it has no
mesh yet.  ``events`` records the bytes and seconds of each save and
restore.
"""
from __future__ import annotations

import json
import os
import threading
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core.stencil import WeightField

_SEP = "/"
# Key suffix marking a leaf that was a WeightField (solver-family stencil
# params); _unflatten re-wraps so restored trees round-trip structurally.
_WF_MARK = "%wf"


def _host_copy(leaf) -> np.ndarray:
    """A host array of ``leaf`` that shares no memory with it."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.to("cpu", copy=True).numpy()
    return np.array(leaf, copy=True)


def _flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """{key: leaf} in the file's key scheme, the leaves as they are."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{_SEP}{k}" if prefix else str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{_SEP}{i}" if prefix else str(i)))
    elif isinstance(tree, WeightField):
        out[prefix + _WF_MARK] = tree
    else:
        out[prefix] = tree
    return out


def _unflatten(flat: dict[str, Any]) -> Any:
    tree: dict = {}
    for key, val in flat.items():
        if key.endswith(_WF_MARK):
            key = key[: -len(_WF_MARK)]
            val = WeightField(val)
        parts = key.split(_SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return tree


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def _check_like(flat: dict[str, np.ndarray], like: dict[str, Any],
                path: str) -> None:
    """Raise unless ``flat`` (a checkpoint's) and ``like`` (a tree's) hold
    the same keys with the same shapes, naming the first that differs."""
    for key in sorted(set(flat) | set(like)):
        if key not in like:
            raise ValueError(f"{path}: key {key!r} is in the checkpoint but "
                             f"not in the tree restored into")
        if key not in flat:
            raise ValueError(f"{path}: key {key!r} of the tree restored into "
                             f"is not in the checkpoint")
        if _shape(flat[key]) != _shape(like[key]):
            raise ValueError(f"{path}: {key!r} has shape "
                             f"{_shape(flat[key])} in the checkpoint and "
                             f"{_shape(like[key])} in the tree")


@torch.no_grad()
def _fill(node: Any, flat: dict[str, np.ndarray], prefix: str = "") -> Any:
    """``node`` with the checkpoint's values: tensors copied in place,
    containers updated in place, any other leaf replaced."""
    def key(k):
        return f"{prefix}{_SEP}{k}" if prefix else str(k)

    if isinstance(node, dict):
        for k, v in node.items():
            node[k] = _fill(v, flat, key(k))
        return node
    if isinstance(node, list):
        node[:] = [_fill(v, flat, key(i)) for i, v in enumerate(node)]
        return node
    if isinstance(node, tuple):
        return type(node)(_fill(v, flat, key(i)) for i, v in enumerate(node))
    if isinstance(node, WeightField):
        return WeightField(flat[prefix + _WF_MARK])
    value = flat[prefix]
    if isinstance(node, torch.Tensor):
        node.copy_(torch.as_tensor(value))
        return node
    return value


class Checkpointer:
    """save(step, tree) / restore_latest() with an async writer thread."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self.events: list[dict] = []

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Write ``tree`` as step ``step``.  The host copies are taken here,
        on the caller's thread: ``tree`` may change as soon as this
        returns."""
        t0 = time.perf_counter()
        flat = {k: _host_copy(v.array if isinstance(v, WeightField) else v)
                for k, v in _flatten(tree).items()}
        event = {"op": "save", "step": step,
                 "bytes": sum(a.nbytes for a in flat.values()),
                 "host_copy_s": time.perf_counter() - t0}
        self.events.append(event)

        def write():
            t1 = time.perf_counter()
            # np.savez appends ".npz" unless the name already ends with it
            tmp = self._path(step) + ".tmp.npz"
            np.savez(tmp, **flat)
            os.replace(tmp, self._path(step))
            with open(os.path.join(self.dir, "manifest.json"), "w") as f:
                json.dump({"latest_step": step}, f)
            self._gc()
            event["write_s"] = time.perf_counter() - t1

        if blocking:
            write()
        else:
            self.wait()
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        ckpts = sorted(f for f in os.listdir(self.dir) if f.startswith("ckpt_")
                       and f.endswith(".npz") and not f.endswith(".tmp.npz"))
        for old in ckpts[: -self.keep]:
            os.remove(os.path.join(self.dir, old))

    def latest_step(self) -> int | None:
        m = os.path.join(self.dir, "manifest.json")
        if not os.path.exists(m):
            return None
        with open(m) as f:
            return json.load(f)["latest_step"]

    def restore(self, step: int, device=None, into: Any | None = None) -> Any:
        """The tree saved as ``step``.  By default its leaves are numpy
        arrays (WeightFields re-wrapped), or tensors on ``device`` where one
        is given.  With ``into``, a tree of the same keys and shapes, the
        values are copied into its tensors in place and ``into`` is
        returned; a key or shape that differs raises ValueError."""
        self.wait()
        t0 = time.perf_counter()
        path = self._path(step)
        with np.load(path) as z:
            flat = {k: z[k] for k in z.files}
        read_s = time.perf_counter() - t0
        if into is not None:
            _check_like(flat, _flatten(into), path)
            tree = _fill(into, flat)
        else:
            if device is not None:
                flat = {k: v if k.endswith(_WF_MARK)
                        else torch.from_numpy(v).to(device)
                        for k, v in flat.items()}
            tree = _unflatten(flat)
        if device is not None or into is not None:
            _sync(tree)
        self.events.append({"op": "restore", "step": step,
                            "bytes": sum(v.nbytes for v in flat.values()),
                            "read_s": read_s,
                            "seconds": time.perf_counter() - t0})
        return tree

    def restore_latest(self, device=None,
                       into: Any | None = None) -> tuple[int, Any] | None:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, device, into)


def _sync(tree: Any) -> None:
    """Wait for the copies onto any card the tree's tensors lie on."""
    devices = {v.device for v in _flatten(tree).values()
               if isinstance(v, torch.Tensor) and v.device.type == "cuda"}
    for dev in devices:
        torch.cuda.synchronize(dev)
