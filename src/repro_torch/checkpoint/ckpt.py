"""Checkpointing: MessagePack + compressed blobs, atomic publish, restore.

Port of ``repro.checkpoint.ckpt``, in its file format: a one-byte codec
id (``0x01`` zstd, ``0x02`` zlib, :mod:`repro_torch.core.codec`), then the
MessagePack of the job-state tree in which every array is a
``{"__nd__": True, "d": raw bytes, "t": dtype name, "s": shape}`` map,
dicts with sorted keys and tuples (the optimizer's ``OptState``) as
arrays.  Where the payload is equal, a file written here is the JAX
package's byte for byte, and each package restores the other's files.
``bfloat16`` leaves are written and read as their 2-byte payload through
an ``int16`` view (numpy has no bfloat16), under the dtype name
``"bfloat16"`` that the JAX package writes.

Writes are atomic (tmp + rename) and keep a bounded history, so a crash
mid-write never destroys the latest good checkpoint.  ``restore_as_jax``
is :func:`restore_as_torch` here.
"""

from __future__ import annotations

import os
import re
import tempfile
from typing import Any

import numpy as np
import torch

from repro_torch._tree import flatten, leaves
from repro_torch.core import codec

_CKPT_RE = re.compile(r"ckpt_(\d+)\.mpz$")

#: the dtype name of bfloat16 leaves in a checkpoint
_BF16 = "bfloat16"


def _pack_leaf(x) -> Any:
    if isinstance(x, torch.Tensor):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:  # tracecheck: disable=TC005 — checkpoint wire format of bf16 LM weights
            return {"__nd__": True, "d": t.view(torch.int16).numpy().tobytes(),
                    "t": _BF16, "s": list(t.shape)}
        x = t.numpy()
    if isinstance(x, np.ndarray):
        return {"__nd__": True, "d": x.tobytes(), "t": str(x.dtype),
                "s": list(x.shape)}
    if isinstance(x, (int, float, str, bool, type(None))):
        return x
    raise TypeError(f"unsupported leaf {type(x)}")


def _pack_tree(tree: Any) -> Any:
    """Tree -> MessagePack-able structure (arrays become dicts), with the
    layout ``jax.tree.map`` gives the JAX package's tree (dict keys
    sorted)."""
    if isinstance(tree, dict):
        return {k: _pack_tree(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):        # NamedTuples too: an array
        return [_pack_tree(x) for x in tree]
    return _pack_leaf(tree)


def _unpack_leaf(x: dict) -> torch.Tensor:
    if x["t"] == _BF16:
        raw = np.frombuffer(x["d"], np.int16).copy()
        return torch.from_numpy(raw).view(torch.bfloat16).reshape(x["s"])  # tracecheck: disable=TC005 — checkpoint wire format of bf16 LM weights
    return torch.from_numpy(np.frombuffer(x["d"], x["t"]).copy()).reshape(x["s"])


def _unpack_tree(obj: Any) -> Any:
    """Inverse of :func:`_pack_tree`: array maps become CPU tensors, tuples
    come back as lists."""
    if isinstance(obj, dict):
        if obj.get("__nd__"):
            return _unpack_leaf(obj)
        return {k: _unpack_tree(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_unpack_tree(x) for x in obj]
    return obj


def save(path_dir: str, step: int, state: Any, keep: int = 3) -> str:
    os.makedirs(path_dir, exist_ok=True)
    blob = codec.compress(codec.packb(_pack_tree(state)), level=3)
    final = os.path.join(path_dir, f"ckpt_{step:08d}.mpz")
    fd, tmp = tempfile.mkstemp(dir=path_dir, suffix=".tmp")
    with os.fdopen(fd, "wb") as f:
        f.write(blob)
    os.replace(tmp, final)                      # atomic publish
    _gc(path_dir, keep)
    return final


def latest_step(path_dir: str) -> int | None:
    if not os.path.isdir(path_dir):
        return None
    steps = [int(m.group(1)) for f in os.listdir(path_dir)
             if (m := _CKPT_RE.search(f))]
    return max(steps) if steps else None


def restore(path_dir: str, step: int | None = None) -> tuple[int, Any]:
    """``(step, tree)`` of a checkpoint (the latest by default), its arrays
    as CPU tensors of the dtype written (tuples as lists)."""
    step = latest_step(path_dir) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {path_dir}")
    path = os.path.join(path_dir, f"ckpt_{step:08d}.mpz")
    with open(path, "rb") as f:
        obj = codec.unpackb(codec.decompress(f.read()))
    return step, _unpack_tree(obj)


def cast_like(h: Any, t: Any) -> Any:
    """Host leaf ``h`` as template leaf ``t`` has it: a tensor takes the
    template's dtype and device (and ``requires_grad``), a numpy array its
    dtype; any other template leaf takes the host value as it is."""
    if isinstance(t, torch.Tensor):
        x = torch.as_tensor(h)
        if tuple(x.shape) != tuple(t.shape):
            raise ValueError(f"checkpoint leaf {tuple(x.shape)} for a template "
                             f"leaf {tuple(t.shape)}")
        x = x.to(device=t.device, dtype=t.dtype)
        return x.requires_grad_(True) if t.requires_grad else x
    if isinstance(t, np.ndarray):
        return np.asarray(h).astype(t.dtype)
    return h


def restore_as_torch(path_dir: str, like: Any, step: int | None = None
                     ) -> tuple[int, Any]:
    """Restore and cast to match a template tree (structure, dtypes and
    devices): the counterpart of the JAX package's ``restore_as_jax``."""
    step, host = restore(path_dir, step)
    flat_h = leaves(host)
    flat_l, unflatten = flatten(like)
    if len(flat_h) != len(flat_l):
        raise ValueError(f"checkpoint has {len(flat_h)} leaves, the template "
                         f"{len(flat_l)}")
    return step, unflatten([cast_like(h, t) for h, t in zip(flat_h, flat_l)])


def _gc(path_dir: str, keep: int) -> None:
    steps = sorted(
        int(m.group(1)) for f in os.listdir(path_dir)
        if (m := _CKPT_RE.search(f)))
    for s in steps[:-keep]:
        os.unlink(os.path.join(path_dir, f"ckpt_{s:08d}.mpz"))
