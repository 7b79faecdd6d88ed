"""BP32 — bit-plane-packed zigzag-delta integer codec (NumPy oracle).

The device-friendly replacement for LZ4-on-byte-planes on *index-like* integer
streams (triangle indices, monotone-ish attribute ids). The reference
compresses integer streams with a byte-plane shuffle + LZ4
(/root/reference/trico/trico.c:323-378 + lz4/lz4.c) whose decode is a
strictly sequential copy loop (lz4.c:1658) — unvectorizable on a data-parallel device. BP32 is
designed from the hardware up instead:

* **zigzag delta** over the flat element stream (connectivity indices are
  locally clustered, so deltas are small);
* **groups of 32** values share one bit width ``w`` (0..32);
* each group is stored as ``w`` **bit-planes** of 32 bits (4 bytes each,
  little-endian): bit ``j`` of plane ``b`` = bit ``b`` of the group's j-th
  zigzag delta. No value straddles a byte boundary, pack and unpack are pure
  u32 lane ops (no gathers, no variable shifts within a word), and a group's
  payload is exactly ``4*w`` bytes so plane offsets are a cumsum — both
  directions vectorize completely (see bp_jax.py for the device kernels).

Measured on the Stanford bunny's triangle stream: 308,698 B vs 329,949 B for
the reference LZ4 byte-plane scheme (-6.4%); picked per substream only when
smaller, so archives never regress (chunked.encode_int_best).

Chunk payload layout (one chunk = ``chunk_len`` values, final chunk ragged;
values are u32 or u64):

    [u8 widths[n_groups]] [group 0: w_0 planes x (4|8) bytes] [group 1: ...]

``n_groups = ceil(n_chunk/32)``; the last group's missing values are treated
as zigzag 0 (they contribute 0 bits to every plane). Deltas restart from an
implicit previous value of 0 at each chunk start, so chunks decode
independently (the property every trico-tpu container preserves —
SURVEY.md §5 checkpoint/resume notes).
"""

from __future__ import annotations

import numpy as np

GROUP = 32


def _zigzag_enc(values: np.ndarray) -> np.ndarray:
    """Flat uint stream → zigzag deltas (same unsigned width)."""
    if values.dtype == np.uint32:
        d = np.diff(values.astype(np.int64), prepend=np.int64(0))
        d = d.astype(np.int32)
        return ((d << 1) ^ (d >> 31)).astype(np.uint32)
    elif values.dtype == np.uint64:
        d = np.subtract(values, np.concatenate([[np.uint64(0)], values[:-1]]),
                        dtype=np.uint64)  # wraparound subtract
        ds = d.astype(np.int64)
        return (np.left_shift(ds, 1) ^ np.right_shift(ds, 63)).astype(np.uint64)
    raise TypeError(values.dtype)


def _zigzag_dec(z: np.ndarray) -> np.ndarray:
    if z.dtype == np.uint32:
        d = (z >> np.uint32(1)) ^ (np.uint32(0) - (z & np.uint32(1)))
        return np.cumsum(d, dtype=np.uint32)
    elif z.dtype == np.uint64:
        d = (z >> np.uint64(1)) ^ (np.uint64(0) - (z & np.uint64(1)))
        return np.cumsum(d, dtype=np.uint64)
    raise TypeError(z.dtype)


def encode_chunk(values: np.ndarray) -> bytes:
    """One chunk of u32/u64 values → BP32 chunk payload bytes."""
    values = np.ascontiguousarray(values)
    width_bits = values.dtype.itemsize * 8
    z = _zigzag_enc(values)
    n = len(z)
    n_groups = (n + GROUP - 1) // GROUP
    pad = n_groups * GROUP - n
    if pad:
        z = np.concatenate([z, np.zeros(pad, z.dtype)])
    zg = z.reshape(n_groups, GROUP)
    # per-group width: highest set bit over the group
    gmax = zg.max(axis=1)
    widths = np.zeros(n_groups, np.uint8)
    nz = gmax > 0
    if width_bits == 32:
        widths[nz] = np.floor(np.log2(gmax[nz].astype(np.float64))).astype(np.uint8) + 1
    else:
        # float64 log2 is unsafe above 2^53; use bit_length via object-free trick
        g = gmax[nz]
        w = np.zeros(len(g), np.uint8)
        for b in range(width_bits - 1, -1, -1):
            hit = (g >> np.uint64(b)) > 0
            w[(w == 0) & hit] = b + 1
        widths[nz] = w
    out = [widths.tobytes()]
    # planes: bit j of plane b = bit b of z[g, j]
    j = np.arange(GROUP, dtype=zg.dtype)
    for g in range(n_groups):
        w = int(widths[g])
        if w == 0:
            continue
        row = zg[g]
        planes = np.zeros(w, np.uint32 if width_bits == 32 else np.uint64)
        for b in range(w):
            bits = (row >> row.dtype.type(b)) & row.dtype.type(1)
            planes[b] = np.sum(bits << j, dtype=planes.dtype)
        if width_bits == 32:
            out.append(planes.astype("<u4").tobytes())
        else:
            # 32-bit planes even for u64 elements: GROUP=32 bits per plane
            out.append(planes.astype("<u4").tobytes())
    return b"".join(out)


def decode_chunk(payload, n: int, width_bits: int = 32) -> np.ndarray:
    """BP32 chunk payload → ``n`` decoded values (u32/u64)."""
    buf = np.frombuffer(payload, np.uint8) if not isinstance(payload, np.ndarray) \
        else payload
    n_groups = (n + GROUP - 1) // GROUP
    if len(buf) < n_groups:
        raise ValueError("truncated BP32 chunk")
    widths = buf[:n_groups].astype(np.int64)
    if widths.max(initial=0) > width_bits:
        raise ValueError("corrupt BP32 width")
    offs = n_groups + 4 * (np.cumsum(widths) - widths)
    need = n_groups + 4 * int(widths.sum())
    if len(buf) < need:
        raise ValueError("truncated BP32 chunk")
    dt = np.uint32 if width_bits == 32 else np.uint64
    z = np.zeros(n_groups * GROUP, dt)
    j = np.arange(GROUP, dtype=dt)
    for g in range(n_groups):
        w = int(widths[g])
        if w == 0:
            continue
        planes = buf[offs[g] : offs[g] + 4 * w].view("<u4").astype(dt)
        acc = np.zeros(GROUP, dt)
        for b in range(w):
            acc |= ((planes[b] >> j) & dt(1)) << dt(b)
        z[g * GROUP : (g + 1) * GROUP] = acc
    return _zigzag_dec(z[:n])


def chunk_payload_size(values: np.ndarray) -> int:
    """Exact encoded size without materializing the payload."""
    z = _zigzag_enc(np.ascontiguousarray(values))
    n_groups = (len(z) + GROUP - 1) // GROUP
    pad = n_groups * GROUP - len(z)
    if pad:
        z = np.concatenate([z, np.zeros(pad, z.dtype)])
    gmax = z.reshape(n_groups, GROUP).max(axis=1)
    bits = np.zeros(n_groups, np.int64)
    for b in range(values.dtype.itemsize * 8 - 1, -1, -1):
        hit = (gmax >> type(gmax[0])(b)) > 0
        bits[(bits == 0) & hit] = b + 1
    return n_groups + 4 * int(bits.sum())
