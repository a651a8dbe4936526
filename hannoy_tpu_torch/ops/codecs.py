"""Vector codecs: f32, binary (0/1), and binary-quantized (±1).

TPU-native replacement for the reference's unaligned-vector layer
(the hannoy crate's ``src/unaligned_vector/``):

* ``f32`` — plain little-endian f32 bytes, ``word_size()==1``
  (reference ``f32.rs:9-55``).
* ``binary`` — 1 bit/dim with rule ``x > 0.0 → 1``, packed into 64-bit
  words so dims are padded up to a multiple of 64; unpacking yields
  0.0/1.0 (reference ``binary.rs:97-262``).
* ``bq`` (binary quantized) — same packing rule but a bit decodes to ``2b-1``
  i.e. ±1.0 (reference ``binary_quantized.rs:94-290``).

The reference implements pack/unpack with NEON/SSE intrinsics
([native-perf] rows in SURVEY §2.1); here the host side is vectorised
numpy over whole batches (``np.packbits``) and the device side represents
packed vectors as ``uint32`` lanes so XOR+``lax.population_count`` run on
the VPU — 32-bit lanes are the TPU-native word, two per reference u64.

Padding bits are zeros, matching the reference's ``from_slice`` padding, so
distances over padded tails agree (issue #78 analogue: unpacked output must
be truncated back to ``dimensions`` by callers).
"""

from __future__ import annotations

import numpy as np

F32 = "f32"
BINARY = "binary"
BQ = "bq"

#: bit granularity of the packed codecs (reference word_size()==64)
WORD_BITS = 64
#: device lane type granularity
LANE_BITS = 32


def word_size(codec: str) -> int:
    """Dims are padded to a multiple of this (reference mod.rs word_size)."""
    return 1 if codec == F32 else WORD_BITS


def padded_dim(dimensions: int, codec: str) -> int:
    """On-store dimension after codec padding (reference writer.rs:309-311)."""
    ws = word_size(codec)
    return (dimensions + ws - 1) // ws * ws


def n_lanes(dimensions: int, codec: str) -> int:
    """Number of uint32 device lanes for one packed vector."""
    if codec == F32:
        raise ValueError("f32 codec has no packed lanes")
    return padded_dim(dimensions, codec) // LANE_BITS


# --------------------------------------------------------------------------
# Host-side batch pack/unpack (numpy)
# --------------------------------------------------------------------------


def pack(vectors: np.ndarray, codec: str) -> np.ndarray:
    """Encode a batch ``[B, D] float`` for storage/device upload.

    Returns ``[B, D] float32`` for f32, else ``[B, n_lanes] uint32`` with
    bit ``i`` of the flattened little-endian bitstream set iff
    ``vectors[b, i] > 0.0``.
    """
    vectors = np.atleast_2d(np.asarray(vectors, dtype=np.float32))
    if codec == F32:
        return vectors.astype(np.float32)
    b, d = vectors.shape
    dp = padded_dim(d, codec)
    bits = np.zeros((b, dp), dtype=np.uint8)
    bits[:, :d] = vectors > 0.0
    # LSB-first within each byte, then little-endian bytes within a lane:
    packed_bytes = np.packbits(bits, axis=1, bitorder="little")
    return packed_bytes.view("<u4").reshape(b, dp // LANE_BITS).astype(np.uint32)


def unpack(packed: np.ndarray, dimensions: int, codec: str) -> np.ndarray:
    """Decode ``pack`` output back to ``[B, dimensions] float32``.

    binary → 0.0/1.0 ; bq → ±1.0 (bit b → 2b-1, reference
    binary_quantized.rs:261-290).
    """
    if codec == F32:
        return np.atleast_2d(np.asarray(packed, dtype=np.float32))[:, :dimensions]
    packed = np.atleast_2d(np.asarray(packed, dtype=np.uint32))
    by = packed.astype("<u4").view(np.uint8).reshape(packed.shape[0], -1)
    bits = np.unpackbits(by, axis=1, bitorder="little")[:, :dimensions]
    if codec == BINARY:
        return bits.astype(np.float32)
    return bits.astype(np.float32) * 2.0 - 1.0


# --------------------------------------------------------------------------
# Store byte (de)serialisation for a single vector
# --------------------------------------------------------------------------


def vector_to_bytes(vector: np.ndarray, codec: str) -> bytes:
    """Serialise one vector (already float) into store value bytes."""
    row = pack(np.asarray(vector, dtype=np.float32)[None, :], codec)[0]
    if codec == F32:
        return row.astype("<f4").tobytes()
    return row.astype("<u4").tobytes()


def vector_from_bytes(data: bytes, codec: str) -> np.ndarray:
    """Deserialise store value bytes into the packed/raw row."""
    if codec == F32:
        return np.frombuffer(data, dtype="<f4").astype(np.float32)
    return np.frombuffer(data, dtype="<u4").astype(np.uint32)


def decoded_len(dimensions: int, codec: str) -> int:
    """Length of the *decoded* vector including padding (reference
    ``UnalignedVector::len``) — hamming normalises by this."""
    return padded_dim(dimensions, codec)
