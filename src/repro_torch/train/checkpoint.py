"""Checkpointing with atomic writes, in the JAX package's on-disk format.

A checkpoint is step_<n>/arrays.npz plus step_<n>/manifest.json with
"step", "time", "digest", "dtypes" and "n_arrays", exactly as the JAX
package's train/checkpoint.py writes it: leaves keyed by their tree path
(repro_torch/tree.py: ".params/tok/embed", ".opt/.step", ".opt/.m/...",
".ef/..."; "/" written as "|" inside the npz), bfloat16 stored as its
uint16 bits tagged "bfloat16" in "dtypes", the same digest.  So a
checkpoint written by either package restores in the other.  The bf16
bits travel through int16 views of torch.bfloat16 (no ml_dtypes).

- save: pull every leaf to the host, write the .npz into a temporary
  directory, fsync, write the manifest, rename the directory into place
  (a torn checkpoint is never mistaken for a valid one), keep the last K.
- restore: read the arrays, check every path of the template is there
  with its shape, then copy them into the template's tensors in place
  (cast to each leaf's dtype), so a full-width state is not allocated
  twice.

A sharded state (the sharded train step's DTensor leaves, on a mesh) is
saved as its full tensors, in the same format: every rank gathers each
leaf in turn (sharding/shards.py gather_full), rank 0 alone writes, and
the ranks meet at a barrier before the call returns.  Restoring into a
sharded template copies each rank's shard of the full array into its
leaf, with the template's placements on the current mesh - so a
checkpoint moves between meshes of any shape and no mesh at all (the
JAX package's elastic restore).
"""
from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
import zipfile
import zlib
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tree import leaves_with_paths

_STEP_RE = re.compile(r"step_(\d+)$")
# what reading a torn or corrupt checkpoint raises
_CORRUPT = (OSError, ValueError, KeyError, EOFError, zipfile.BadZipFile,
            zlib.error)


def _encode(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A leaf on the host as npz stores it: bfloat16 as its uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _decode(arr: np.ndarray, dtype_tag: str) -> torch.Tensor:
    if dtype_tag == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _is_dtensor(t) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _digest(arrays: Dict[str, np.ndarray]) -> str:
    h = hashlib.sha256()
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes()[:1 << 20])
    return h.hexdigest()[:16]


def save_checkpoint(directory: str, step: int, state: Any,
                    keep: int = 3) -> str:
    """Write `state` as step_<step>, keep the newest `keep`.  A sharded
    state: every rank calls this; rank 0 writes the full tensors."""
    if any(_is_dtensor(t) for _, t in leaves_with_paths(state)):
        return _save_sharded(directory, step, state, keep)
    return _save(directory, step, leaves_with_paths(state), keep)


def _save_sharded(directory: str, step: int, state: Any, keep: int) -> str:
    import torch.distributed as dist

    from ..sharding.shards import gather_full
    rank0 = dist.get_rank() == 0
    pairs = []
    for path, leaf in leaves_with_paths(state):
        full = gather_full(leaf) if _is_dtensor(leaf) else leaf
        if rank0:
            pairs.append((path, full.detach().cpu()))
        del full
    out = _save(directory, step, pairs, keep) if rank0 else \
        str(Path(directory) / f"step_{step}")
    dist.barrier()
    return out


def _save(directory: str, step: int, pairs, keep: int) -> str:
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    ck = d / f"step_{step}"
    tmp = d / f".tmp_step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()

    arrays, dtypes = {}, {}
    for path, leaf in pairs:
        arrays[path], dtypes[path] = _encode(leaf)
    npz_tmp = tmp / "arrays.npz"
    with open(npz_tmp, "wb") as f:
        np.savez(f, **{k.replace("/", "|"): v for k, v in arrays.items()})
        f.flush()
        os.fsync(f.fileno())
    manifest = {"step": step, "time": time.time(),
                "digest": _digest(arrays),
                "dtypes": dtypes,
                "n_arrays": len(arrays)}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if ck.exists():
        shutil.rmtree(ck)
    os.rename(tmp, ck)                      # atomic publish

    # retention
    steps = sorted(all_checkpoints(directory))
    for s in steps[:-keep]:
        shutil.rmtree(d / f"step_{s}", ignore_errors=True)
    return str(ck)


def all_checkpoints(directory: str):
    d = Path(directory)
    if not d.exists():
        return []
    out = []
    for p in d.iterdir():
        m = _STEP_RE.search(p.name)
        if m and (p / "manifest.json").exists():
            out.append(int(m.group(1)))
    return sorted(out)


def latest_checkpoint(directory: str) -> Optional[int]:
    steps = all_checkpoints(directory)
    return steps[-1] if steps else None


def _validate(ck: Path) -> bool:
    try:
        manifest = json.loads((ck / "manifest.json").read_text())
        with np.load(ck / "arrays.npz") as z:
            return len(z.files) == manifest["n_arrays"]
    except _CORRUPT:
        return False


def restore_checkpoint(directory: str, step: int, state_template: Any
                       ) -> Tuple[Any, int]:
    """Restore `step` into the tensors of `state_template` (a state of the
    same structure, e.g. a freshly initialised one), in place: a DTensor
    leaf takes this rank's shard of the saved array.  Returns
    (state_template, step).  Raises if the checkpoint fails validation or
    lacks a leaf of the template or has it in another shape; the template
    is then left untouched."""
    ck = Path(directory) / f"step_{step}"
    if not _validate(ck):
        raise IOError(f"checkpoint {ck} failed validation")
    manifest = json.loads((ck / "manifest.json").read_text())
    dtypes = manifest.get("dtypes", {})
    with np.load(ck / "arrays.npz") as z:
        arrays = {k.replace("|", "/"):
                  _decode(z[k], dtypes.get(k.replace("|", "/"),
                                           str(z[k].dtype)))
                  for k in z.files}
    pairs = []
    for path, leaf in leaves_with_paths(state_template):
        if path not in arrays:
            raise IOError(f"checkpoint {ck} has no array {path}")
        arr = arrays[path]
        if tuple(arr.shape) != tuple(leaf.shape):
            raise IOError(f"checkpoint {ck}: {path} is {tuple(arr.shape)}, "
                          f"the state wants {tuple(leaf.shape)}")
        pairs.append((leaf, arr))
    with torch.no_grad():
        for leaf, arr in pairs:
            if _is_dtensor(leaf):
                from ..sharding.shards import local_slice
                leaf.to_local().copy_(local_slice(
                    arr, leaf.placements, leaf.device_mesh).to(leaf.dtype))
            else:
                leaf.copy_(arr.to(leaf.dtype))
    return state_template, step


def restore_latest(directory: str, state_template: Any
                   ) -> Optional[Tuple[Any, int]]:
    """Restore the newest VALID checkpoint, skipping corrupt ones."""
    for step in reversed(all_checkpoints(directory)):
        try:
            return restore_checkpoint(directory, step, state_template)
        except _CORRUPT:
            continue
    return None
