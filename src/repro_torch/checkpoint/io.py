"""Checkpoints: flat .npz snapshots of param trees and of run state.

The port of ``repro.checkpoint.io``, in the same file formats; a file
either package writes restores in the other.  Two payload families:

  * `save`/`restore` — param trees (arrays only), keyed by the reference's
    tree paths (``stage0/l0/attn/wq``), bfloat16 stored as float32, the
    step under ``__step__``.  A tree is nested dicts / lists of tensors or
    arrays, or a model zoo `Transformer`, written as the reference's tree
    (its layers stacked, ``repro_torch.carry.model_params_to_reference``).
    `restore` validates against a `like_tree`: a shape mismatch, a missing
    key or a file key absent from it is a `ValueError`, never a silent
    drop.
  * `save_state`/`restore_state` — named arrays plus the JSON metadata
    under the reserved ``__meta__`` key (RNG bit-generator states,
    cursors, and the originating `ExperimentSpec` for provenance), with a
    sha256 content digest inside it.

Writes are atomic (tmp file + ``os.replace``), so a run killed mid-save
leaves the previous checkpoint intact; `latest_checkpoint` then resumes
from the newest complete snapshot.  Stale ``*.tmp`` leftovers of a
mid-save kill are swept on the next successful save and are never resume
candidates.

The digest is over canonical array bytes and the metadata JSON, not over
the npz bytes (zip headers embed timestamps).  `restore_state` verifies it
and raises `CheckpointCorruptError` on truncation, bit rot or a digest
mismatch; ``latest_checkpoint(..., valid_only=True)`` then falls back to
the newest checkpoint that still verifies.
"""
from __future__ import annotations

import hashlib
import json
import os
import zipfile

import numpy as np
import torch

from repro_torch.device import resolve_device

#: key prefix reserved for format metadata, exempt from like_tree checks
RESERVED_PREFIX = "__"
#: filename prefix the runtime uses for block-boundary snapshots
CKPT_PREFIX = "ckpt_"

#: key carrying the sha256 content digest inside the ``__meta__`` blob
DIGEST_KEY = "__digest__"


class CheckpointCorruptError(ValueError):
    """A checkpoint file is unreadable or fails digest verification."""


def _sweep_stale_tmp(directory: str) -> None:
    """Remove ``*.tmp`` / ``*.tmp.npz`` leftovers of mid-save kills."""
    try:
        names = os.listdir(directory)
    except OSError:
        return
    for name in names:
        if name.endswith(".tmp") or name.endswith(".tmp.npz"):
            try:
                os.remove(os.path.join(directory, name))
            except OSError:
                pass


def _atomic_savez(path: str, flat: dict) -> None:
    directory = os.path.dirname(path) or "."
    os.makedirs(directory, exist_ok=True)
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    # a previous save killed between np.savez and os.replace leaves its
    # tmp file behind forever: sweep those now that this save landed
    _sweep_stale_tmp(directory)


def _is_model(tree) -> bool:
    """A model zoo model: a `Transformer` or an `EncDec` (a module with
    its config)."""
    return isinstance(tree, torch.nn.Module) and hasattr(tree, "cfg")


def _path_leaves(tree, prefix: tuple = ()):
    """(key path, leaf) in the reference's flatten order: dict keys sorted,
    list and tuple entries by index, None an empty subtree."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _path_leaves(tree[k], prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _path_leaves(v, prefix + (str(i),))
    elif tree is not None:
        yield "/".join(prefix), tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":          # npz has no bf16: as f32
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree) -> dict:
    if _is_model(tree):
        from repro_torch.carry import model_params_to_reference
        tree = model_params_to_reference(tree)
    return {key: _to_numpy(leaf) for key, leaf in _path_leaves(tree)}


def _shapes(like_tree) -> dict:
    """{key path: shape} of a like tree, without reading its values."""
    if _is_model(like_tree):
        from repro_torch.carry import reference_layout
        return {k: shape for k, (shape, _) in
                reference_layout(like_tree).items()}
    return {key: tuple(leaf.shape) if hasattr(leaf, "shape")
            else np.shape(leaf) for key, leaf in _path_leaves(like_tree)}


def save(path: str, tree, step: int | None = None):
    flat = _flatten(tree)
    if step is not None:
        flat["__step__"] = np.asarray(step)
    _atomic_savez(path, flat)


def _like(leaf, arr: np.ndarray, device):
    """`arr` as `leaf`'s kind: a tensor of its dtype on its device (on
    `device` where it lives on ``meta``), an array of its dtype, or its
    Python scalar type."""
    if isinstance(leaf, torch.Tensor):
        dev = resolve_device(device) if leaf.is_meta else leaf.device
        return torch.from_numpy(np.array(arr)).to(device=dev,
                                                  dtype=leaf.dtype)
    if isinstance(leaf, (bool, int, float)):
        return type(leaf)(arr)
    return np.asarray(arr).astype(np.asarray(leaf).dtype)


def _rebuild(tree, restored: dict, device, prefix: tuple = ()):
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], restored, device, prefix + (str(k),))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        out = [_rebuild(v, restored, device, prefix + (str(i),))
               for i, v in enumerate(tree)]
        return type(tree)(out)
    if tree is None:
        return None
    return _like(tree, restored["/".join(prefix)], device)


def restore(path: str, like_tree, device=None):
    """Restore into the structure of `like_tree`.

    Every non-reserved key in the file must exist in `like_tree` and every
    reference leaf must exist in the file with a matching shape — any
    divergence raises `ValueError` naming the offending key (a checkpoint
    from a different run shape should fail loudly, not load partially).
    A model like tree (`Transformer`, `EncDec`) gives a new model of its
    kind, each leaf in its dtype in the model; other leaves come back in their like leaf's dtype, on its
    device.  Leaves on the ``meta`` device (``abstract_params``) land on
    `device`, the GPU unless the caller passes another.
    """
    flat_like = _shapes(like_tree)
    restored = {}
    with np.load(path) as data:
        extra = sorted(k for k in data.files
                       if not k.startswith(RESERVED_PREFIX)
                       and k not in flat_like)
        if extra:
            raise ValueError(
                f"checkpoint {path!r} holds key(s) {extra} absent from "
                f"like_tree — refusing to silently drop them")
        for key, shape in flat_like.items():
            if key not in data.files:
                raise ValueError(
                    f"checkpoint {path!r} is missing key {key!r} "
                    f"required by like_tree")
            arr = data[key]
            if arr.shape != shape:
                raise ValueError(
                    f"checkpoint key {key!r}: stored shape {arr.shape} "
                    f"does not match like_tree shape {shape}")
            restored[key] = arr
    if _is_model(like_tree):
        from repro_torch.carry import model_params_from_reference
        tree: dict = {}
        for key, arr in restored.items():
            *parents, last = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[last] = arr
        dev = (resolve_device(device) if like_tree.embed.is_meta
               else like_tree.embed.device)
        return model_params_from_reference(tree, like_tree.cfg, dev)
    return _rebuild(like_tree, restored, device)


def restore_step(path: str) -> int | None:
    with np.load(path) as data:
        return int(data["__step__"]) if "__step__" in data.files else None


def _state_digest(arrays: dict, meta: dict) -> str:
    """sha256 over canonical array bytes + metadata JSON: (key, dtype,
    shape, bytes) per array in key order, then the sorted-key metadata
    JSON, so the digest is a pure function of the checkpoint's content."""
    h = hashlib.sha256()
    for key in sorted(arrays):
        arr = np.ascontiguousarray(arrays[key])
        h.update(key.encode())
        h.update(str(arr.dtype).encode())
        h.update(repr(arr.shape).encode())
        h.update(arr.tobytes())
    h.update(json.dumps(meta, sort_keys=True).encode())
    return h.hexdigest()


def save_state(path: str, arrays: dict, meta: dict) -> str:
    """Atomically write a mixed arrays + JSON-metadata snapshot.

    `arrays` maps names to array-likes (names must not use the reserved
    ``__`` prefix); `meta` is any JSON-serializable dict: PCG64 state words
    are plain (big) Python ints, which JSON carries exactly.  A sha256
    content digest is embedded under ``__digest__`` inside the ``__meta__``
    blob and verified by `restore_state`.
    """
    bad = sorted(k for k in arrays if k.startswith(RESERVED_PREFIX))
    if bad:
        raise ValueError(f"array key(s) {bad} use the reserved "
                         f"{RESERVED_PREFIX!r} prefix")
    if DIGEST_KEY in meta:
        raise ValueError(f"meta key {DIGEST_KEY!r} is reserved")
    flat = {k: np.asarray(v) for k, v in arrays.items()}
    meta_full = dict(meta)
    meta_full[DIGEST_KEY] = _state_digest(flat, meta)
    flat["__meta__"] = np.asarray(json.dumps(meta_full))
    _atomic_savez(path, flat)
    return path


def restore_state(path: str, verify: bool = True) -> tuple[dict, dict]:
    """Load a `save_state` snapshot -> (arrays, meta).

    Unreadable files (truncation, zip damage) and digest mismatches (bit
    rot) raise `CheckpointCorruptError`.  Snapshots written without a
    digest load without verification.  ``verify=False`` skips the digest
    check (forensics on a known-bad file).
    """
    try:
        with np.load(path) as data:
            raw = {k: data[k] for k in data.files}
    except (OSError, EOFError, ValueError, KeyError,
            zipfile.BadZipFile) as exc:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} is unreadable "
            f"(truncated or damaged): {exc}") from exc
    if "__meta__" not in raw:
        raise ValueError(
            f"{path!r} is not a run-state checkpoint (no __meta__ "
            "payload; param-tree snapshots restore via `restore`)")
    try:
        meta = json.loads(str(raw["__meta__"][()]))
    except json.JSONDecodeError as exc:
        raise CheckpointCorruptError(
            f"checkpoint {path!r} holds an unparseable __meta__ "
            f"blob: {exc}") from exc
    arrays = {k: v for k, v in raw.items()
              if not k.startswith(RESERVED_PREFIX)}
    digest = meta.pop(DIGEST_KEY, None)
    if verify and digest is not None:
        actual = _state_digest(arrays, meta)
        if actual != digest:
            raise CheckpointCorruptError(
                f"checkpoint {path!r} failed digest verification "
                f"(stored {digest[:12]}…, recomputed {actual[:12]}…): "
                "the file was corrupted after writing")
    return arrays, meta


def latest_checkpoint(directory: str, prefix: str = CKPT_PREFIX,
                      valid_only: bool = False) -> str | None:
    """Newest ``<prefix><number>.npz`` in `directory`, or None.

    "Newest" orders by the numeric suffix (the rounds-done cursor the
    runtime puts in the filename), not by mtime.  Half-written ``*.tmp``
    leftovers are never candidates.  With ``valid_only=True`` candidates
    are tried newest first and the first that passes `restore_state`'s
    digest verification wins.
    """
    if not os.path.isdir(directory):
        return None
    candidates = []
    for name in os.listdir(directory):
        if not (name.startswith(prefix) and name.endswith(".npz")):
            continue
        if ".tmp" in name:
            continue
        try:
            key = int(name[len(prefix):-len(".npz")])
        except ValueError:
            continue
        candidates.append((key, name))
    for _, name in sorted(candidates, reverse=True):
        path = os.path.join(directory, name)
        if not valid_only:
            return path
        try:
            restore_state(path)
        except CheckpointCorruptError:
            continue
        return path
    return None
