"""Pure-Python base16384 codec (port of tpu_rvc/utils/base16384.py, which
replaces the pybase16384 C extension of the reference's model-identity
hashing, infer/modules/vc/hash.py:8).

base16384 packs each 7 input bytes into 4 UTF-16 code units in the CJK range
(offset 0x4E00, 14 bits each, big-endian bit order).  A trailing remainder of
r in 1..6 bytes is zero-padded, encoded into ceil(8r/14) code units, and
marked with '=' followed by chr(r).
"""

from __future__ import annotations

_OFFSET = 0x4E00
# code units produced for a remainder of r bytes
_REM_UNITS = {1: 1, 2: 2, 3: 2, 4: 3, 5: 3, 6: 4}


def _pack7(b: bytes) -> tuple:
    return (
        (b[0] << 6) | (b[1] >> 2),
        ((b[1] & 0x3) << 12) | (b[2] << 4) | (b[3] >> 4),
        ((b[3] & 0xF) << 10) | (b[4] << 2) | (b[5] >> 6),
        ((b[5] & 0x3F) << 8) | b[6],
    )


def _unpack7(v: tuple) -> bytes:
    return bytes((
        (v[0] >> 6) & 0xFF,
        ((v[0] & 0x3F) << 2 | (v[1] >> 12)) & 0xFF,
        (v[1] >> 4) & 0xFF,
        ((v[1] & 0xF) << 4 | (v[2] >> 10)) & 0xFF,
        (v[2] >> 2) & 0xFF,
        ((v[2] & 0x3) << 6 | (v[3] >> 8)) & 0xFF,
        v[3] & 0xFF,
    ))


def encode_to_string(data: bytes) -> str:
    out = []
    n = len(data)
    full, rem = divmod(n, 7)
    for i in range(full):
        for v in _pack7(data[i * 7:(i + 1) * 7]):
            out.append(chr(_OFFSET + v))
    if rem:
        block = data[full * 7:] + b"\x00" * (7 - rem)
        vals = _pack7(block)
        for v in vals[:_REM_UNITS[rem]]:
            out.append(chr(_OFFSET + v))
        out.append("=")
        out.append(chr(rem))
    return "".join(out)


def decode_from_string(s: str) -> bytes:
    rem = 0
    if len(s) >= 2 and s[-2] == "=":
        rem = ord(s[-1])
        body = s[:-2]
    else:
        body = s
    vals = [ord(c) - _OFFSET for c in body]
    out = bytearray()
    if rem:
        n_rem_units = _REM_UNITS[rem]
        full_vals, rem_vals = vals[:-n_rem_units], vals[-n_rem_units:]
    else:
        full_vals, rem_vals = vals, []
    for i in range(0, len(full_vals), 4):
        out += _unpack7(tuple(full_vals[i:i + 4]))
    if rem:
        padded = tuple(rem_vals + [0] * (4 - len(rem_vals)))
        out += _unpack7(padded)[:rem]
    return bytes(out)
