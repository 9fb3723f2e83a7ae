"""Base-space encodings shared by host packing code and device kernels.

The device kernels operate on small-integer base codes in a 5-letter alphabet
(A, C, G, T, N) — the same alphabet size the reference preallocates its POA
engine with (reference: src/polisher.cpp:154, `prealloc(window_length, 5)`).
"""

import numpy as np

# Base codes. Anything that is not ACGT (IUPAC ambiguity codes etc.) maps to N.
A, C, G, T, N = 0, 1, 2, 3, 4
ALPHABET = 5

_ENCODE = np.full(256, N, dtype=np.uint8)
for _i, _ch in enumerate("ACGTN"):
    _ENCODE[ord(_ch)] = _i
    _ENCODE[ord(_ch.lower())] = _i

_DECODE = np.frombuffer(b"ACGTN", dtype=np.uint8)

# Reverse-complement table over raw ASCII, matching the reference semantics:
# A<->T, C<->G, all other characters copied verbatim
# (reference: src/sequence.cpp:49-84).
_COMP = np.arange(256, dtype=np.uint8)
for _a, _b in (("A", "T"), ("C", "G"), ("a", "t"), ("c", "g")):
    _COMP[ord(_a)] = ord(_b)
    _COMP[ord(_b)] = ord(_a)
COMPLEMENT_TABLE = bytes(_COMP.tobytes())


def encode_bases(data: bytes) -> np.ndarray:
    """ASCII bytes -> uint8 base codes (0..4)."""
    return _ENCODE[np.frombuffer(data, dtype=np.uint8)]


def decode_bases(codes: np.ndarray) -> bytes:
    """uint8 base codes -> ASCII bytes."""
    return _DECODE[np.asarray(codes, dtype=np.uint8)].tobytes()


def reverse_complement(data: bytes) -> bytes:
    """Reverse complement of raw ASCII sequence data. Accepts the
    ingest plane's ``memoryview`` payloads (one copy here is
    unavoidable — the result is a new reversed string anyway)."""
    if not isinstance(data, (bytes, bytearray)):
        data = bytes(data)
    return data.translate(COMPLEMENT_TABLE)[::-1]
