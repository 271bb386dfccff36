"""Run-state checkpoints: flat .npz snapshots of named arrays plus one JSON
metadata blob.

The port of the run-state half of ``repro.checkpoint.io``, in the same file
format: named arrays plus the JSON metadata under the reserved ``__meta__``
key (RNG bit-generator states, cursors, and the originating
`ExperimentSpec` for provenance), with a sha256 content digest inside it.
A snapshot either package writes restores in the other.  The param-tree
``save``/``restore`` of the reference is not ported yet.

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

#: key prefix reserved for format metadata
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
            "payload)")
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
