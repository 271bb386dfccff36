"""Deterministic fault draws and checkpoint-corruption helpers (the port
of ``repro.faults.inject``, the same NumPy code on the same generators).

`sample_fault_rows` turns a `FaultProfile` into per-round fault inputs of
the round step with a **fixed draw layout**: every fault family consumes
its block of the generator whether or not it is enabled, so turning one
fault kind on or off never shifts another's realization.  The generator is
the run's own fault stream (`Experiment._fault_rows`, seeded from
``fl.seed + 7717``), independent of the delay and channel-trace streams.

`truncate_file` models a kill in the middle of a write and `bitflip_file`
silent media rot; `repro_torch.checkpoint.io.restore_state`'s sha256
digest must detect both.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from repro_torch.faults.profile import FaultProfile

#: per-client fault codes of a round's fault row
CODE_CLEAN = 0
CODE_NAN = 1       # upload is NaN garbage
CODE_INF = 2       # upload is inf garbage
CODE_STALE = 3     # upload replays the previous round's iterate


class InjectedCrashError(RuntimeError):
    """A service block crash injected by a `FaultProfile.crash_prob`."""


def sample_fault_rows(profile: FaultProfile, rng: np.random.Generator,
                      rounds: int, n: int) -> "tuple[np.ndarray, np.ndarray]":
    """(codes, parity_bad) fault inputs for `rounds` rounds of n clients.

    codes: (rounds, n) int32 of CODE_* values; parity_bad: (rounds,)
    float32 0/1 flags of the rounds whose parity contribution is
    corrupted.  Four blocks are always drawn, in this order: NaN hits, NaN
    kind, stale hits, parity hits.
    """
    rounds, n = int(rounds), int(n)
    u_nan = rng.random((rounds, n))
    u_kind = rng.random((rounds, n))
    u_stale = rng.random((rounds, n))
    u_par = rng.random(rounds)

    codes = np.zeros((rounds, n), np.int32)
    if profile.nan_prob > 0.0:
        if profile.nan_kind == "nan":
            kind = np.full((rounds, n), CODE_NAN, np.int32)
        elif profile.nan_kind == "inf":
            kind = np.full((rounds, n), CODE_INF, np.int32)
        else:
            kind = np.where(u_kind < 0.5, CODE_NAN, CODE_INF).astype(np.int32)
        codes = np.where(u_nan < profile.nan_prob, kind, codes)
    if profile.stale_prob > 0.0:
        codes = np.where((codes == CODE_CLEAN)
                         & (u_stale < profile.stale_prob),
                         CODE_STALE, codes).astype(np.int32)
    parity_bad = (u_par < profile.parity_corrupt_prob).astype(np.float32)
    return codes, parity_bad


def truncate_file(path: str, frac: float = 0.5) -> None:
    """Truncate `path` to `frac` of its size (a kill mid-write)."""
    if not (0.0 <= frac < 1.0):
        raise ValueError(f"frac={frac} must lie in [0, 1)")
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.truncate(max(0, int(size * frac)))


def bitflip_file(path: str, n_flips: int = 8,
                 rng: Optional[np.random.Generator] = None) -> None:
    """XOR-flip one bit in each of `n_flips` bytes of `path`.

    Without an rng the positions are deterministic (spread through the
    middle of the file, where an npz's member data lies); an rng draws
    them uniformly.
    """
    size = os.path.getsize(path)
    if size == 0:
        return
    if rng is None:
        positions = [(size // 3 + k * max(1, size // (3 * max(n_flips, 1))))
                     % size for k in range(n_flips)]
    else:
        positions = rng.integers(0, size, size=n_flips).tolist()
    with open(path, "r+b") as fh:
        for pos in positions:
            fh.seek(pos)
            byte = fh.read(1)
            fh.seek(pos)
            fh.write(bytes([byte[0] ^ 0x40]))


def corrupt_checkpoint(path: str, kind: str = "truncate",
                       rng: Optional[np.random.Generator] = None) -> str:
    """Corrupt a checkpoint file in place; returns the mode applied.

    kind: "truncate" | "bitflip" | "mix" (an rng, or without one a coin
    from the file size, picks between the two).
    """
    if kind == "mix":
        if rng is not None:
            kind = "truncate" if rng.random() < 0.5 else "bitflip"
        else:
            kind = "truncate" if os.path.getsize(path) % 2 else "bitflip"
    if kind == "truncate":
        truncate_file(path)
    elif kind == "bitflip":
        bitflip_file(path, rng=rng)
    else:
        raise ValueError(f"unknown corruption kind {kind!r}")
    return kind
