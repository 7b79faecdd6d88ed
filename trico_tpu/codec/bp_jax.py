"""BP32 device codec — bit-plane-packed zigzag deltas (u32), JAX/XLA.

Format defined by the NumPy oracle in bp_ref.py. This is the device integer
coder: both encode and decode are gather-free array programs built from the
same monotone log-shift compaction the FP codec uses
(fp_jax._compact_monotone/_expand_monotone), so integer streams run the full
encode→decode pipeline on device and shard over a mesh chunk axis exactly
like FP streams (mesh_codec).

Contrast with the scheme it replaces: the reference's integer path is a byte
plane shuffle + LZ4 (trico.c:323-378), whose decode is a strictly sequential
token walk (lz4.c:1658) that cannot vectorize on any SIMD hardware — a
fundamental mismatch for a data-parallel device. BP32's group-of-32 bit-planes need no
variable-length *parsing*: plane offsets are a cumsum of the width header,
every byte's position is closed-form, and the group payload is exactly
4*width bytes.

Layout recap (per chunk of L values, G = L/32 groups):
  [u8 widths[G]] then for each group g: widths[g] planes x 4 bytes (LE).
Byte k of plane b of group g holds bits j=8k..8k+7: bit (j-8k) = bit b of
the group's j-th zigzag delta. Deltas restart from 0 at each chunk start.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .fp_jax import (
    _compact_monotone,
    _cumsum_l,
    _expand_monotone,
    _map_row_blocks,
    _pad_rows,
)

GROUP = 32


def bp32_max_chunk_bytes(L: int) -> int:
    assert L % GROUP == 0
    return L // GROUP + 4 * L  # width header + all 32 planes live


def bp64_max_chunk_bytes(L: int) -> int:
    assert L % GROUP == 0
    return L // GROUP + 8 * L  # width header + all 64 planes live


def _zigzag_device(values):
    """(C, L) uint32 → zigzag deltas, per-chunk (prev value 0 at start)."""
    C, _ = values.shape
    prev = jnp.concatenate(
        [jnp.zeros((C, 1), jnp.uint32), values[:, :-1]], axis=1)
    d = values - prev
    sign = jnp.where((d >> 31) != 0, jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
    return (d << 1) ^ sign


def _unzigzag_device(z):
    d = (z >> 1) ^ (jnp.uint32(0) - (z & 1))
    return jnp.cumsum(d, axis=1, dtype=jnp.uint32)


@functools.partial(jax.jit, static_argnums=())
def encode_bp32_chunks(values: jax.Array):
    """(C, L) uint32 → ((C, B) uint8 payloads, (C,) int32 sizes)."""
    # slot arrays are 4L bytes + a 4L candidate build: budget like f64 (2x f32)
    return _map_row_blocks(_encode_bp32_impl, 2 * values.shape[1], values)


def _encode_bp32_impl(values):
    C, L = values.shape
    G = L // GROUP
    B = bp32_max_chunk_bytes(L)
    z = _zigzag_device(values).reshape(C, G, GROUP)

    # per-group bit width: w = #bits of the group max
    gmax = jnp.max(z, axis=2)  # (C, G)
    w = jnp.zeros((C, G), jnp.int32)
    for b in range(GROUP):
        w = w + (gmax >= jnp.uint32(1) << b).astype(jnp.int32)

    # candidate bytes: slot (g, b, k) = byte k of plane b of group g
    # byte(g,b,k) = sum_j ((z[g, 8k+j] >> b) & 1) << j,  j in 0..7
    b_arr = jnp.arange(GROUP, dtype=jnp.uint32)[None, None, :, None]  # planes
    acc = jnp.zeros((C, G, GROUP, 4), jnp.uint32)
    for j in range(8):
        vj = z[:, :, j::8]  # (C, G, 4): values 8k+j for k=0..3
        bits = (vj[:, :, None, :] >> b_arr) & 1  # (C, G, 32planes, 4bytes)
        acc = acc | (bits << j)
    cand = acc.reshape(C, 4 * L)  # slot order: g-major, then plane b, byte k

    # live slots: plane b of group g exists iff b < w_g
    b_idx = jnp.broadcast_to(
        jnp.arange(GROUP, dtype=jnp.int32)[None, None, :, None], (C, G, GROUP, 4)
    ).reshape(C, 4 * L)
    w_slot = jnp.broadcast_to(w[:, :, None, None], (C, G, GROUP, 4)).reshape(C, 4 * L)
    live = b_idx < w_slot

    # monotone left-compaction: slot (g,b,k) sits at src = 128g + 4b + k and
    # lands at dest = 4*cumw_before(g) + 4b + k  ⇒  move = 128g - 4*cumw_before
    cumw = _cumsum_l(w)  # inclusive per-chunk cumsum over groups
    before = cumw - w
    g_idx = jnp.arange(G, dtype=jnp.int32)
    move_g = 128 * g_idx[None, :] - 4 * before  # (C, G), >= 0, nondecreasing
    move = jnp.broadcast_to(move_g[:, :, None], (C, G, 128)).reshape(C, 4 * L)

    region = _compact_monotone(cand, move, live, 8).astype(jnp.uint8)
    n_plane_bytes = 4 * cumw[:, -1]
    pos = jnp.arange(4 * L, dtype=jnp.int32)[None, :]
    region = jnp.where(pos < n_plane_bytes[:, None], region, 0)

    out = jnp.concatenate([w.astype(jnp.uint8), region], axis=1)
    assert out.shape == (C, B)
    return out, (G + n_plane_bytes).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(1,))
def decode_bp32_chunks(payloads: jax.Array, L: int):
    """(C, B) uint8 BP32 payloads → (C, L) uint32 values."""
    return _map_row_blocks(
        lambda p: _decode_bp32_impl(p, L), 2 * L, payloads)


def _decode_bp32_impl(payloads, L):
    C, B = payloads.shape
    G = L // GROUP
    w = payloads[:, :G].astype(jnp.int32)  # (C, G)
    region = payloads[:, G : G + 4 * L].astype(jnp.uint32)

    cumw = _cumsum_l(w)
    before = cumw - w
    g_idx = jnp.arange(G, dtype=jnp.int32)
    move_g = 128 * g_idx[None, :] - 4 * before
    move = jnp.broadcast_to(move_g[:, :, None], (C, G, 128)).reshape(C, 4 * L)
    b_idx = jnp.broadcast_to(
        jnp.arange(GROUP, dtype=jnp.int32)[None, None, :, None], (C, G, GROUP, 4)
    ).reshape(C, 4 * L)
    w_slot = jnp.broadcast_to(w[:, :, None, None], (C, G, GROUP, 4)).reshape(C, 4 * L)
    live = b_idx < w_slot

    # inverse of the pack compaction: region byte at rank r moves right to
    # its slot. _expand_monotone wants per-RANK displacements, so compact the
    # (sbits-wide) slot ids to rank order first — the same slot_by_rank trick
    # as the FP v2 parse (fp_jax/fp64_jax _parse_*_impl).
    sbits = max(4 * L - 1, 1).bit_length()
    slot_id = jnp.broadcast_to(
        jnp.arange(4 * L, dtype=jnp.uint32)[None, :], (C, 4 * L))
    slot_by_rank = _compact_monotone(slot_id, move, live, sbits).astype(jnp.int32)
    ranks = jnp.arange(4 * L, dtype=jnp.int32)[None, :]
    n_bytes = 4 * cumw[:, -1]
    bytes_by_slot = _expand_monotone(
        region, slot_by_rank - ranks, ranks < n_bytes[:, None], 8
    ).reshape(C, G, GROUP, 4)

    # reassemble planes and extract bits: value j of group g =
    # sum_b ((byte(g, b, j>>3) >> (j&7)) & 1) << b
    planes = (bytes_by_slot[:, :, :, 0]
              | (bytes_by_slot[:, :, :, 1] << 8)
              | (bytes_by_slot[:, :, :, 2] << 16)
              | (bytes_by_slot[:, :, :, 3] << 24))  # (C, G, 32 planes)
    j = jnp.arange(GROUP, dtype=jnp.uint32)[None, None, :]
    z = jnp.zeros((C, G, GROUP), jnp.uint32)
    for b in range(GROUP):
        z = z | (((planes[:, :, b : b + 1] >> j) & 1) << b)
    return _unzigzag_device(z.reshape(C, L))


# ---------------------------------------------------------------------------
# u64 variant: values carried as (hi, lo) u32 word pairs (no process-wide x64 mode; the
# 64-bit integer path — same convention as the f64 FP codec, fp64_jax.py).
# Up to 64 bit-planes per group; otherwise identical structure to u32.
# ---------------------------------------------------------------------------


def _zigzag64_device(hi, lo):
    C, _ = hi.shape
    ph = jnp.concatenate([jnp.zeros((C, 1), jnp.uint32), hi[:, :-1]], axis=1)
    pl = jnp.concatenate([jnp.zeros((C, 1), jnp.uint32), lo[:, :-1]], axis=1)
    # 64-bit subtract with borrow
    dl = lo - pl
    borrow = (lo < pl).astype(jnp.uint32)
    dh = hi - ph - borrow
    # z = (d << 1) ^ (d >> 63 arithmetic)
    sign = jnp.where((dh >> 31) != 0, jnp.uint32(0xFFFFFFFF), jnp.uint32(0))
    zh = ((dh << 1) | (dl >> 31)) ^ sign
    zl = (dl << 1) ^ sign
    return zh, zl


def _unzigzag64_device(zh, zl):
    m = jnp.uint32(0) - (zl & 1)
    dl = ((zl >> 1) | (zh << 31)) ^ m
    dh = (zh >> 1) ^ m
    # 64-bit prefix sum via 16-bit limbs (exact for L <= 65536: each limb
    # cumsum stays < 2^32)
    lo16 = dl & 0xFFFF
    hi16 = dl >> 16
    s_lo = jnp.cumsum(lo16, axis=1, dtype=jnp.uint32)
    s_hi = jnp.cumsum(hi16, axis=1, dtype=jnp.uint32)
    vl = (s_hi << 16) + s_lo
    carry = (s_hi >> 16) + (((s_hi & 0xFFFF) + (s_lo >> 16)) >> 16)
    vh = jnp.cumsum(dh, axis=1, dtype=jnp.uint32) + carry
    return vh, vl


@functools.partial(jax.jit, static_argnums=())
def encode_bp64_chunks(hi: jax.Array, lo: jax.Array):
    """(C, L) u32 hi/lo word pairs → ((C, B) uint8 payloads, (C,) sizes)."""
    assert hi.shape[1] <= 65536, "BP64 chunk_len cap (16-bit-limb cumsum)"
    return _map_row_blocks(_encode_bp64_impl, 4 * hi.shape[1], hi, lo)


def _encode_bp64_impl(hi, lo):
    C, L = hi.shape
    G = L // GROUP
    B = bp64_max_chunk_bytes(L)
    zh, zl = _zigzag64_device(hi, lo)
    zh = zh.reshape(C, G, GROUP)
    zl = zl.reshape(C, G, GROUP)

    maxh = jnp.max(zh, axis=2)
    maxl = jnp.max(zl, axis=2)
    wl = jnp.zeros((C, G), jnp.int32)
    wh = jnp.zeros((C, G), jnp.int32)
    for b in range(GROUP):
        wl = wl + (maxl >= jnp.uint32(1) << b).astype(jnp.int32)
        wh = wh + (maxh >= jnp.uint32(1) << b).astype(jnp.int32)
    # 64-bit group width: bits(max64) = 32 + bits(max hi word) when any hi
    # word is nonzero, else bits(max lo word)
    w = jnp.where(wh > 0, 32 + wh, wl)

    # candidate bytes for 64 planes: slot (g, b, k), b-major within group
    b_planes = jnp.arange(GROUP, dtype=jnp.uint32)[None, None, :, None]
    accl = jnp.zeros((C, G, GROUP, 4), jnp.uint32)
    acch = jnp.zeros((C, G, GROUP, 4), jnp.uint32)
    for j in range(8):
        vl_j = zl[:, :, j::8]
        vh_j = zh[:, :, j::8]
        accl = accl | ((((vl_j[:, :, None, :]) >> b_planes) & 1) << j)
        acch = acch | ((((vh_j[:, :, None, :]) >> b_planes) & 1) << j)
    cand = jnp.concatenate([accl, acch], axis=2).reshape(C, 8 * L)

    b_idx = jnp.broadcast_to(
        jnp.arange(2 * GROUP, dtype=jnp.int32)[None, None, :, None],
        (C, G, 2 * GROUP, 4)).reshape(C, 8 * L)
    w_slot = jnp.broadcast_to(w[:, :, None, None],
                              (C, G, 2 * GROUP, 4)).reshape(C, 8 * L)
    live = b_idx < w_slot

    cumw = _cumsum_l(w)
    before = cumw - w
    g_idx = jnp.arange(G, dtype=jnp.int32)
    move_g = 256 * g_idx[None, :] - 4 * before
    move = jnp.broadcast_to(move_g[:, :, None], (C, G, 256)).reshape(C, 8 * L)

    region = _compact_monotone(cand, move, live, 8).astype(jnp.uint8)
    n_plane_bytes = 4 * cumw[:, -1]
    pos = jnp.arange(8 * L, dtype=jnp.int32)[None, :]
    region = jnp.where(pos < n_plane_bytes[:, None], region, 0)

    out = jnp.concatenate([w.astype(jnp.uint8), region], axis=1)
    assert out.shape == (C, B)
    return out, (G + n_plane_bytes).astype(jnp.int32)


@functools.partial(jax.jit, static_argnums=(1,))
def decode_bp64_chunks(payloads: jax.Array, L: int):
    """(C, B) uint8 BP64 payloads → ((C, L) hi, (C, L) lo) u32 word pairs."""
    return _map_row_blocks(
        lambda p: _decode_bp64_impl(p, L), 4 * L, payloads)


def _decode_bp64_impl(payloads, L):
    C, B = payloads.shape
    G = L // GROUP
    w = payloads[:, :G].astype(jnp.int32)
    region = payloads[:, G : G + 8 * L].astype(jnp.uint32)

    cumw = _cumsum_l(w)
    before = cumw - w
    g_idx = jnp.arange(G, dtype=jnp.int32)
    move_g = 256 * g_idx[None, :] - 4 * before
    move = jnp.broadcast_to(move_g[:, :, None], (C, G, 256)).reshape(C, 8 * L)
    b_idx = jnp.broadcast_to(
        jnp.arange(2 * GROUP, dtype=jnp.int32)[None, None, :, None],
        (C, G, 2 * GROUP, 4)).reshape(C, 8 * L)
    w_slot = jnp.broadcast_to(w[:, :, None, None],
                              (C, G, 2 * GROUP, 4)).reshape(C, 8 * L)
    live = b_idx < w_slot

    sbits = max(8 * L - 1, 1).bit_length()
    slot_id = jnp.broadcast_to(
        jnp.arange(8 * L, dtype=jnp.uint32)[None, :], (C, 8 * L))
    slot_by_rank = _compact_monotone(slot_id, move, live, sbits).astype(jnp.int32)
    ranks = jnp.arange(8 * L, dtype=jnp.int32)[None, :]
    n_bytes = 4 * cumw[:, -1]
    bytes_by_slot = _expand_monotone(
        region, slot_by_rank - ranks, ranks < n_bytes[:, None], 8
    ).reshape(C, G, 2 * GROUP, 4)

    planes = (bytes_by_slot[:, :, :, 0]
              | (bytes_by_slot[:, :, :, 1] << 8)
              | (bytes_by_slot[:, :, :, 2] << 16)
              | (bytes_by_slot[:, :, :, 3] << 24))  # (C, G, 64 planes)
    j = jnp.arange(GROUP, dtype=jnp.uint32)[None, None, :]
    zl = jnp.zeros((C, G, GROUP), jnp.uint32)
    zh = jnp.zeros((C, G, GROUP), jnp.uint32)
    for b in range(GROUP):
        zl = zl | (((planes[:, :, b : b + 1] >> j) & 1) << b)
        zh = zh | (((planes[:, :, GROUP + b : GROUP + b + 1] >> j) & 1) << b)
    return _unzigzag64_device(zh.reshape(C, L), zl.reshape(C, L))
