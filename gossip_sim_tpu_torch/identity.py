"""Node identity layer: pubkeys, base58, stake buckets, and the pubkey<->index map.

The engine works on dense int32 node indices; 32-byte pubkeys exist only at
the I/O edge.  This module provides:

  * ``Pubkey`` — a 32-byte identity with byte-wise ordering (reference:
    solana_sdk Pubkey ordering, used by gossip.rs:1064 ``nodes.sort_by_key``)
    and base58 string form (string ordering is the consume_messages tie-break,
    gossip.rs:638-645).
  * ``pubkey_new_unique`` — deterministic counter-based pubkey generator
    mirroring ``Pubkey::new_unique`` (big-endian counter in the first 8 bytes),
    used to reproduce reference test fixtures.
  * ``stake_buckets_array`` — log2 stake bucketing (reference:
    push_active_set.rs:190-196).
  * ``NodeIndex`` — the bidirectional pubkey<->index mapping.  Indices are
    assigned in **base58-string sort order** so that integer index order equals
    the reference's string tie-break order; the dense engine then tie-breaks on
    the index alone.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

import numpy as np

from .constants import LAMPORTS_PER_SOL, NUM_PUSH_ACTIVE_SET_ENTRIES

_B58_ALPHABET = "123456789ABCDEFGHJKLMNPQRSTUVWXYZabcdefghijkmnopqrstuvwxyz"
_B58_INDEX = {c: i for i, c in enumerate(_B58_ALPHABET)}


def b58encode(raw: bytes) -> str:
    """Base58 (bitcoin alphabet) encode, preserving leading zero bytes as '1's."""
    n_zeros = len(raw) - len(raw.lstrip(b"\0"))
    num = int.from_bytes(raw, "big")
    chars = []
    while num > 0:
        num, rem = divmod(num, 58)
        chars.append(_B58_ALPHABET[rem])
    return "1" * n_zeros + "".join(reversed(chars))


def b58decode(s: str, length: int = 32) -> bytes:
    n_ones = len(s) - len(s.lstrip("1"))
    num = 0
    for c in s[n_ones:]:
        num = num * 58 + _B58_INDEX[c]
    return b"\0" * n_ones + num.to_bytes(length - n_ones, "big")


class Pubkey:
    """32-byte node identity. Ordered byte-wise; displayed as base58."""

    __slots__ = ("raw", "_s")

    def __init__(self, raw: bytes):
        assert len(raw) == 32
        self.raw = raw
        self._s = None

    @classmethod
    def from_string(cls, s: str) -> "Pubkey":
        return cls(b58decode(s, 32))

    def to_string(self) -> str:
        if self._s is None:
            self._s = b58encode(self.raw)
        return self._s

    def __str__(self):
        return self.to_string()

    def __repr__(self):
        return f"Pubkey({self.to_string()})"

    def __eq__(self, other):
        return isinstance(other, Pubkey) and self.raw == other.raw

    def __lt__(self, other):
        return self.raw < other.raw

    def __le__(self, other):
        return self.raw <= other.raw

    def __hash__(self):
        return hash(self.raw)


_unique_lock = threading.Lock()
_unique_counter = 1


def pubkey_new_unique() -> Pubkey:
    """Counter-based unique pubkey: big-endian counter in bytes [0..8).

    Mirrors ``Pubkey::new_unique`` so reference test fixtures (hardcoded base58
    strings like ``1111111QLbz7JHiBTspS962RLKV8GndWFwiEaqKM``) reproduce.
    """
    global _unique_counter
    with _unique_lock:
        i = _unique_counter
        _unique_counter += 1
    return Pubkey(i.to_bytes(8, "big") + b"\0" * 24)


def reset_unique_pubkeys(start: int = 1) -> None:
    """Reset the new_unique counter (test fixtures, and journal resume —
    a resumed sweep restores the counter so later synthetic clusters draw
    the same pubkeys an uninterrupted run would, resilience.py)."""
    global _unique_counter
    with _unique_lock:
        _unique_counter = int(start)


def peek_unique_pubkeys() -> int:
    """The next value ``pubkey_new_unique`` will consume (the run journal's
    position marker, resilience.py; does not advance the counter)."""
    with _unique_lock:
        return _unique_counter


def stake_buckets_array(stakes_lamports: np.ndarray) -> np.ndarray:
    """Log2 stake bucket per node: ``min(bit_length(stake //
    LAMPORTS_PER_SOL), 24)`` (push_active_set.rs:190-196)."""
    sol = np.asarray(stakes_lamports, dtype=np.uint64) // np.uint64(LAMPORTS_PER_SOL)
    # bit_length via log2-free loop on uint64: use frexp-safe integer method.
    out = np.zeros(sol.shape, dtype=np.int32)
    v = sol.copy()
    while np.any(v):
        nz = v > 0
        out[nz] += 1
        v >>= np.uint64(1)
    return np.minimum(out, NUM_PUSH_ACTIVE_SET_ENTRIES - 1)


@dataclass
class NodeIndex:
    """Bidirectional pubkey <-> dense index mapping.

    Indices are assigned in base58-string order so that ``index_a < index_b``
    iff ``str(pk_a) < str(pk_b)``; the engine's (hops, index) inbound ranking
    then matches the reference's (hops, pubkey-string) sort
    (gossip.rs:638-645) exactly.
    """

    pubkeys: list  # index -> Pubkey
    stakes: np.ndarray  # index -> lamports (uint64)
    _index: dict = None  # pubkey raw bytes -> index

    @classmethod
    def from_stakes(cls, accounts: dict) -> "NodeIndex":
        """accounts: {Pubkey | str: stake_lamports}."""
        pairs = []
        for pk, stake in accounts.items():
            if not isinstance(pk, Pubkey):
                pk = Pubkey.from_string(pk)
            pairs.append((pk.to_string(), pk, int(stake)))
        pairs.sort(key=lambda t: t[0])
        pubkeys = [p for _, p, _ in pairs]
        stakes = np.array([s for _, _, s in pairs], dtype=np.uint64)
        index = {p.raw: i for i, p in enumerate(pubkeys)}
        return cls(pubkeys=pubkeys, stakes=stakes, _index=index)

    def __len__(self):
        return len(self.pubkeys)

    def index_of(self, pk: Pubkey) -> int:
        return self._index[pk.raw]
