"""Streaming checkpointing — the paper's file/container streaming applied
to persistence: the checkpoint is written **one state-dict item at a
time** using the same framed item format as the wire (so a checkpoint
file can be served directly by ``FileStreamer`` and consumed
incrementally by ``ContainerReceiver``). Peak writer memory = one
serialized item, never the whole model.

Mirror of ``src/repro/checkpoint/streaming_ckpt.py``; the files are
bitwise the reference's, so either package loads the other's.

Layout:  item_count (u32) | serialized items (see
:mod:`repro_torch.core.serialization`). Optionally each float item is
quantized on disk (``fmt``: the wire format at rest). A CUDA tensor
quantizes on the card (blockwise8: B1, nf4/fp4: B4) and a quantized
item dequantizes on the loading device (B2 / B5 on the card).
"""
from __future__ import annotations

import json
import os
import struct
from collections.abc import Callable, Iterator
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import serialization as ser
from repro_torch.core.quantization import QuantizedTensor, dequantize, quantize
from repro_torch.utils import mem
from repro_torch.utils.device import resolve_device
from repro_torch.utils.trees import as_tensor, flatten_state_dict, unflatten_state_dict

_U32 = struct.Struct("<I")


def _is_float(value: Any) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_floating_point()
    return bool(np.issubdtype(np.asarray(value).dtype, np.floating))


def save_checkpoint(path: str, tree: Any, *, fmt: Optional[str] = None) -> int:
    """Write ``tree`` (nested dict of tensors or arrays) item by item.
    Returns bytes. ``fmt``: optional quantization format for at-rest
    compression; a float item quantizes on its own device."""
    flat = flatten_state_dict(tree)
    total = 0
    with open(path, "wb") as fh:
        fh.write(_U32.pack(len(flat)))
        for name, value in flat.items():
            if fmt is not None and _is_float(value):
                if not isinstance(value, torch.Tensor):
                    value = as_tensor(value, "cpu")
                value = quantize(value, fmt)
            item = ser.serialize_item(name, value)
            with mem.record_hold(len(item)):
                fh.write(item)
            total += len(item)
    return total + 4


def iter_checkpoint(path: str, device: Any = None) -> Iterator[tuple[str, torch.Tensor]]:
    """Stream items off disk one at a time (peak memory = one item), as
    tensors on ``device`` (default: the card); quantized items
    dequantize there."""
    device = resolve_device(device)
    with open(path, "rb") as fh:
        (n,) = _U32.unpack(fh.read(4))
        for _ in range(n):
            prefix = fh.read(4)
            (hlen,) = _U32.unpack(prefix)
            prefix += fh.read(hlen)
            # the body length follows from the item's own header
            total = ser.declared_item_nbytes(prefix)
            if total is None:
                raise ValueError(f"{path}: unreadable item header {prefix[4:]!r}")
            buf = prefix + fh.read(total - len(prefix))
            with mem.record_hold(len(buf)):
                name, value, _ = ser.deserialize_item(buf)
            if isinstance(value, QuantizedTensor):
                yield name, dequantize(value, device)
            else:
                yield name, as_tensor(value, device)


def load_checkpoint(path: str, device: Any = None) -> dict[str, Any]:
    return unflatten_state_dict(dict(iter_checkpoint(path, device)))


def load_checkpoint_streaming(
    path: str, consume: Callable[[str, Any], None], device: Any = None
) -> int:
    """Incremental load: hand each item to ``consume`` without ever
    materializing the whole dict."""
    count = 0
    for name, value in iter_checkpoint(path, device):
        consume(name, value)
        count += 1
    return count


# ---------------------------------------------------------------------------
# Live-server round state (crash/resume for the federation plane)
# ---------------------------------------------------------------------------

def save_server_state(ckpt_dir: str, rnd: int, weights: Any,
                      meta: Optional[dict[str, Any]] = None,
                      keep: int = 3) -> str:
    """Atomically persist one completed federation round.

    Two files per round: ``round_NNNNNN.ckpt`` — the flat global weights
    in the wire item format (unquantized, so a resume is bitwise) — and
    ``round_NNNNNN.json`` — round number + caller metadata (roster,
    round log). Both are written to a temp name, fsynced, and renamed
    into place, weights first: the meta JSON is the **commit point**, so
    a crash at any instant leaves either a complete older checkpoint or
    a complete newer one, never a half-valid state. Keeps the newest
    ``keep`` rounds and prunes older pairs. Returns the meta path.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    wname = f"round_{rnd:06d}.ckpt"
    wtmp = os.path.join(ckpt_dir, wname + ".tmp")
    save_checkpoint(wtmp, dict(weights))
    with open(wtmp, "rb") as fh:
        os.fsync(fh.fileno())
    os.replace(wtmp, os.path.join(ckpt_dir, wname))
    doc = {"round": int(rnd), "weights": wname, **dict(meta or {})}
    mname = f"round_{rnd:06d}.json"
    mtmp = os.path.join(ckpt_dir, mname + ".tmp")
    with open(mtmp, "w") as fh:
        json.dump(doc, fh)
        fh.flush()
        os.fsync(fh.fileno())
    mpath = os.path.join(ckpt_dir, mname)
    os.replace(mtmp, mpath)
    rounds = sorted(
        f[:-5] for f in os.listdir(ckpt_dir)
        if f.startswith("round_") and f.endswith(".json"))
    for stem in rounds[:-keep] if keep > 0 else []:
        for suffix in (".json", ".ckpt"):
            try:
                os.unlink(os.path.join(ckpt_dir, stem + suffix))
            except OSError:
                pass
    return mpath


def latest_server_state(ckpt_dir: str, device: Any = None) -> Optional[dict[str, Any]]:
    """Newest complete round checkpoint in ``ckpt_dir``, or ``None``.

    Scans meta files newest-first and returns the first whose weights
    file loads, as ``{"round", "weights" (flat state dict on ``device``),
    "meta"}``. The weights load **flat**, never through
    :func:`load_checkpoint`: unflattening dotted wire names into nested
    dicts would change the state-dict shape the server folds and
    downlinks.
    """
    if not os.path.isdir(ckpt_dir):
        return None
    metas = sorted(
        (f for f in os.listdir(ckpt_dir)
         if f.startswith("round_") and f.endswith(".json")),
        reverse=True)
    for mname in metas:
        try:
            with open(os.path.join(ckpt_dir, mname)) as fh:
                doc = json.load(fh)
            wpath = os.path.join(ckpt_dir, doc["weights"])
            weights = dict(iter_checkpoint(wpath, device))
        except (OSError, ValueError, KeyError, struct.error):
            continue  # torn leftovers from a crash mid-write: skip
        return {"round": int(doc["round"]), "weights": weights, "meta": doc}
    return None
