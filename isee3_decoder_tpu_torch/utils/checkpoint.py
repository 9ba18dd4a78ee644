"""Checkpoint and resume of the streaming chain's state.

The reference keeps its stream state (carrier estimate, lock, symbol
phase, Viterbi metrics and decision window, sample counters) in process
memory (SURVEY.md §5.4).  Here that state is an explicit tree — the
receive chain's ``ChainCarry``, a ``PMCarry``, a Viterbi state — so a
checkpoint is that tree written to disk, and a long many-channel decode
can stop and resume exactly.

Format (.npz, version 2), the JAX package's: one array per leaf,
``leaf_0`` ... in flattening order, and a JSON manifest
(``__manifest__``, its bytes as uint8) with the format version, the leaf
count and every leaf's key path, dtype and shape.  Key paths are written
as the JAX package writes them (``jax.tree_util.keystr``: ``.field`` for
a NamedTuple field or an attribute, ``['key']`` for a dict key, ``[0]``
for a list or tuple item; dict keys in sorted order; None holds no
leaf), and dtypes by their numpy names, so a file written by either
package restores in the other for the same structure.  Version-1 files
(no manifest) load too.

The tree may hold NamedTuples, dataclasses (the Viterbi states), dicts,
lists, tuples, None and ``models.decode.DecodeStreamState`` (by its
``batch``, ``lock``, ``pos`` and ``sync_start``); its leaves are
tensors, numpy arrays and Python scalars.  ``restore_pytree`` checks the
leaf count, key paths, shapes and dtypes against the caller's template
before it builds any state, and puts each tensor leaf on its template
leaf's device.  A ``ChainCarry`` restores onto
``models.pipeline.chain_carry_template`` of the file's manifest.
"""

from __future__ import annotations

import dataclasses
import json
import os
from pathlib import Path
from typing import Any

import numpy as np
import torch

from isee3_decoder_tpu_torch.models.decode import DecodeStreamState

FORMAT_VERSION = 2
_STREAM_FIELDS = ("batch", "lock", "pos", "sync_start")


def _attrs(tree: Any) -> tuple[str, ...] | None:
    """The fields a node holds by name (None for other nodes and leaves)."""
    if isinstance(tree, DecodeStreamState):
        return _STREAM_FIELDS
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return tree._fields
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return tuple(f.name for f in dataclasses.fields(tree))
    return None


def _flatten(tree: Any, path: str = "") -> list[tuple[str, Any]]:
    """(key path, leaf) pairs in the JAX package's flattening order."""
    if tree is None:
        return []
    fields = _attrs(tree)
    if fields is not None:
        return [pair for f in fields
                for pair in _flatten(getattr(tree, f), f"{path}.{f}")]
    if isinstance(tree, dict):
        return [pair for k in sorted(tree)
                for pair in _flatten(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, (list, tuple)):
        return [pair for i, x in enumerate(tree)
                for pair in _flatten(x, f"{path}[{i}]")]
    return [(path, tree)]


def _unflatten(template: Any, leaves: list) -> Any:
    """A tree of the template's structure with the next leaves (popped
    from the front of ``leaves``)."""
    if template is None:
        return None
    fields = _attrs(template)
    if isinstance(template, DecodeStreamState):
        out = DecodeStreamState(template.batch)
        for f in fields:
            setattr(out, f, _unflatten(getattr(template, f), leaves))
        return out
    if fields is not None:
        vals = {f: _unflatten(getattr(template, f), leaves) for f in fields}
        if isinstance(template, tuple):
            return type(template)(**vals)
        return dataclasses.replace(template, **vals)
    if isinstance(template, dict):
        vals = {k: _unflatten(template[k], leaves) for k in sorted(template)}
        return {k: vals[k] for k in template}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(x, leaves) for x in template)
    return leaves.pop(0)


def _as_numpy(leaf: Any) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _dtype_name(leaf: Any) -> str | None:
    """The numpy name of a leaf's dtype (None for a Python scalar)."""
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).removeprefix("torch.")
    if isinstance(leaf, np.ndarray | np.generic):
        return str(leaf.dtype)
    return None


def save_pytree(path: str | os.PathLike, tree: Any) -> None:
    """Write a tree of tensors, arrays and scalars to ``path`` (.npz) with
    its manifest of key paths, dtypes and shapes."""
    pairs = _flatten(tree)
    arrays = {f"leaf_{i}": _as_numpy(leaf) for i, (_, leaf) in enumerate(pairs)}
    manifest = {
        "format_version": FORMAT_VERSION,
        "nleaves": len(pairs),
        "leaves": [
            {
                "path": p,
                "dtype": str(arrays[f"leaf_{i}"].dtype),
                "shape": list(arrays[f"leaf_{i}"].shape),
            }
            for i, (p, _) in enumerate(pairs)
        ],
    }
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(
        path,
        __manifest__=np.frombuffer(json.dumps(manifest).encode(), dtype=np.uint8),
        **arrays,
    )


def load_manifest(path: str | os.PathLike) -> dict | None:
    """The manifest of a checkpoint (None for a version-1 file)."""
    with np.load(path) as data:
        if "__manifest__" in data.files:
            return json.loads(bytes(data["__manifest__"].tobytes()).decode())
    return None


def _restore_leaf(new: np.ndarray, old: Any) -> Any:
    if isinstance(old, torch.Tensor):
        return torch.as_tensor(new, device=old.device).to(old.dtype)
    if isinstance(old, np.ndarray | np.generic):
        return new
    if isinstance(old, bool | int | float | complex):
        return type(old)(new.item())
    return new


def restore_pytree(path: str | os.PathLike, template: Any) -> Any:
    """Restore a tree saved by save_pytree (by either package) onto the
    structure of ``template`` (e.g. a fresh carry of the same shapes).
    Checks the leaf count, key paths, shapes and dtypes against the
    manifest and the template before it builds any state; tensor leaves
    land on the template leaf's device with its dtype, scalar leaves take
    the template leaf's Python type."""
    pairs = _flatten(template)
    paths = [p for p, _ in pairs]
    leaves = [leaf for _, leaf in pairs]
    with np.load(path) as data:
        if "__manifest__" in data.files:
            manifest = json.loads(bytes(data["__manifest__"].tobytes()).decode())
            if manifest["format_version"] > FORMAT_VERSION:
                raise ValueError(
                    f"checkpoint format {manifest['format_version']} is newer "
                    f"than supported {FORMAT_VERSION}")
            if manifest["nleaves"] != len(leaves):
                raise ValueError(
                    f"checkpoint has {manifest['nleaves']} leaves, template "
                    f"has {len(leaves)}")
            for i, (m, p) in enumerate(zip(manifest["leaves"], paths)):
                if m["path"] != p:
                    raise ValueError(
                        f"leaf {i}: checkpoint path {m['path']!r} != template "
                        f"path {p!r} — structure changed since save")
        restored = [np.asarray(data[f"leaf_{i}"]) for i in range(len(leaves))]
    for i, (new, old) in enumerate(zip(restored, leaves)):
        if hasattr(old, "shape") and tuple(new.shape) != tuple(old.shape):
            raise ValueError(
                f"leaf {i} ({paths[i]}): shape {new.shape} != template "
                f"{tuple(old.shape)}")
        old_dtype = _dtype_name(old)
        if old_dtype is not None and str(new.dtype) != old_dtype:
            raise ValueError(
                f"leaf {i} ({paths[i]}): dtype {new.dtype} != template "
                f"{old_dtype}")
    return _unflatten(template, [_restore_leaf(new, old)
                                 for new, old in zip(restored, leaves)])
