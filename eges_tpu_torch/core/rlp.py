"""RLP — recursive length prefix serialization.

The port's copy of ``eges_tpu/core/rlp.py``, unchanged.

Canonical wire/storage encoding for every block, transaction, consensus
message and DB record, same role as the reference's ``rlp/`` package
(ref: rlp/encode.go, rlp/decode.go; Geec messages ride it too,
core/geec_state.go:569, consensus/geec/election/election_go.go:104).

Value model: an *item* is ``bytes`` or a ``list`` of items.  Helpers map
Python ints and fixed-width fields to the canonical big-endian-no-leading-
zero byte form geth uses.  Decoding is strict: non-canonical encodings
(leading zeros in lengths, single bytes < 0x80 wrapped in a string header)
are rejected, matching the reference's canonicality rules.
"""

from __future__ import annotations

Item = "bytes | list[Item]"


class RLPError(ValueError):
    pass


def encode_uint(x: int) -> bytes:
    """Int -> minimal big-endian bytes (0 -> b'')."""
    if x < 0:
        raise RLPError("negative integer")
    if x == 0:
        return b""
    return x.to_bytes((x.bit_length() + 7) // 8, "big")


def decode_uint(b: bytes) -> int:
    if b[:1] == b"\x00":
        raise RLPError("non-canonical integer (leading zero)")
    return int.from_bytes(b, "big")


def _encode_length(length: int, offset: int) -> bytes:
    if length < 56:
        return bytes([offset + length])
    lb = encode_uint(length)
    return bytes([offset + 55 + len(lb)]) + lb


def encode(item) -> bytes:
    """Encode bytes / int / list (nested) to RLP."""
    if isinstance(item, int):
        item = encode_uint(item)
    if isinstance(item, (bytes, bytearray, memoryview)):
        b = bytes(item)
        if len(b) == 1 and b[0] < 0x80:
            return b
        return _encode_length(len(b), 0x80) + b
    if isinstance(item, (list, tuple)):
        payload = b"".join(encode(x) for x in item)
        return _encode_length(len(payload), 0xC0) + payload
    raise RLPError(f"cannot RLP-encode {type(item)!r}")


def _decode_at(data: bytes, pos: int):
    """Decode one item at ``pos``; returns (item, next_pos)."""
    if pos >= len(data):
        raise RLPError("truncated input")
    b0 = data[pos]
    if b0 < 0x80:
        return bytes([b0]), pos + 1
    if b0 < 0xB8:  # short string
        n = b0 - 0x80
        end = pos + 1 + n
        if end > len(data):
            raise RLPError("truncated string")
        s = data[pos + 1 : end]
        if n == 1 and s[0] < 0x80:
            raise RLPError("non-canonical single byte")
        return s, end
    if b0 < 0xC0:  # long string
        ln = b0 - 0xB7
        if pos + 1 + ln > len(data):
            raise RLPError("truncated length")
        lb = data[pos + 1 : pos + 1 + ln]
        if lb[:1] == b"\x00":
            raise RLPError("non-canonical length")
        n = int.from_bytes(lb, "big")
        if n < 56:
            raise RLPError("non-canonical long string")
        end = pos + 1 + ln + n
        if end > len(data):
            raise RLPError("truncated string")
        return data[pos + 1 + ln : end], end
    if b0 < 0xF8:  # short list
        n = b0 - 0xC0
        end = pos + 1 + n
        if end > len(data):
            raise RLPError("truncated list")
        return _decode_list(data, pos + 1, end), end
    # long list
    ln = b0 - 0xF7
    if pos + 1 + ln > len(data):
        raise RLPError("truncated length")
    lb = data[pos + 1 : pos + 1 + ln]
    if lb[:1] == b"\x00":
        raise RLPError("non-canonical length")
    n = int.from_bytes(lb, "big")
    if n < 56:
        raise RLPError("non-canonical long list")
    end = pos + 1 + ln + n
    if end > len(data):
        raise RLPError("truncated list")
    return _decode_list(data, pos + 1 + ln, end), end


def _decode_list(data: bytes, pos: int, end: int) -> list:
    out = []
    while pos < end:
        item, pos = _decode_at(data, pos)
        out.append(item)
    if pos != end:
        raise RLPError("list payload overrun")
    return out


def decode(data: bytes):
    """Decode a single RLP item; trailing bytes are an error."""
    item, end = _decode_at(bytes(data), 0)
    if end != len(data):
        raise RLPError("trailing bytes")
    return item


def peek_first_uint(data: bytes) -> int | None:
    """First element of an RLP ``[uint, ...]`` frame, WITHOUT decoding
    the body — the message-code peek the gossip mux runs on every
    inbound frame (a full :func:`decode` of a megabyte block reply just
    to route it would double the parse cost of the hot path).  Returns
    None for anything that isn't a list opening with a small canonical
    uint."""
    data = bytes(data)
    if not data or data[0] < 0xC0:
        return None
    pos = 1 if data[0] < 0xF8 else 1 + (data[0] - 0xF7)
    if pos >= len(data):
        return None
    h = data[pos]
    if h < 0x80:
        # raw single byte; 0x00 is the non-canonical zero (canonical
        # zero is the empty string 0x80), mirroring decode_uint
        return h if h else None
    if h < 0xB8:
        v = data[pos + 1 : pos + 1 + (h - 0x80)]
        if len(v) != h - 0x80 or v[:1] == b"\x00" \
                or (len(v) == 1 and v[0] < 0x80):
            return None
        return int.from_bytes(v, "big")
    return None
