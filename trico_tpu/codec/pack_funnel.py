"""Word-funnel residual packing — the device path for FP-substream emission.

The original device pack (fp_jax._pack_f32_chunks_v2_impl) moves *bytes*: every
value gets 4 candidate byte slots and a monotone log-shift network compacts the
(C, 4L) slot array — ~log2(4L) full passes over 4L u32 slots per chunk. This
module reformulates emission at u32-*word* granularity so the heavy data
movement runs over L lanes instead of 4L slots, with byte alignment handled by
funnel shifts (classic CPU varint-packing trick, rebuilt as array ops):

1. group 4 consecutive values; build each group's dense byte image as 4
   big-endian u32 words by funnel shifts of the values' left-aligned residuals
   (pure elementwise, no data movement);
2. every group word contributes to at most 2 destination words of the final
   byte stream (dest = byte_offset >> 2, split by ``byte_offset & 3``): two
   elementwise funnel contributions c0/c1;
3. two *merging* monotone compaction networks (one per contribution kind)
   move contributions to their destination word lane. Unlike the plain
   log-shift network, same-destination items are allowed: when an arrival
   lands on a live resident both necessarily carry the same remaining
   displacement (proof in ``_pair_compact_or``), so the payloads OR together.

Byte-for-byte identical to the slot network (it is the same stream, assembled
word-wise). Reference format being reproduced: residuals big-endian, low
``len`` bytes only (floating_point_stream_compression.c:20-73); the reordered
v2 layout hoists the tags (see fp_jax.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np


def _cumsum_l(x):
    from .fp_jax import _cumsum_l as impl

    return impl(x)


def _pair_compact_or_xla(carrier, payload, nbits):
    """Merging left-compaction over lanes: XLA shifted-select formulation.

    ``carrier`` is ``disp << 1 | 1`` for live items, 0 for dead; ``payload``
    rides along. An item at lane s with displacement d ends at lane s - d;
    items that collide mid-network necessarily share the same destination AND
    the same remaining displacement (dest nondecreasing + disp nondecreasing
    over live lanes ⇒ equal-position items have equal dest; see module doc),
    so the merge rule ORs their payloads. Returns the payload array indexed by
    destination lane (0 where no item landed).
    """
    C = carrier.shape[0]
    for b in range(nbits):
        d = 1 << b
        zc = jnp.zeros((C, d), carrier.dtype)
        cand_c = jnp.concatenate([carrier[:, d:], zc], axis=1)
        cand_p = jnp.concatenate([payload[:, d:], zc], axis=1)
        bit = jnp.uint32(d << 1)
        arrives = (cand_c & bit) != 0
        departs = (carrier & bit) != 0
        stays = ((carrier & 1) != 0) & ~departs
        carrier = jnp.where(arrives, cand_c - bit, jnp.where(departs, 0, carrier))
        payload = jnp.where(
            arrives & stays, payload | cand_p,
            jnp.where(arrives, cand_p, jnp.where(departs, 0, payload)))
    return jnp.where(carrier == 1, payload, 0)


def _pair_compact_or(dest, payload, live, L):
    """Dispatch the merging compaction: items at lane s → lane dest[s].

    dest must be nondecreasing and s - dest[s] nondecreasing over live lanes.
    """
    disp = jnp.arange(L, dtype=jnp.int32)[None, :] - dest
    carrier = jnp.where(live, ((disp.astype(jnp.uint32)) << 1) | 1, 0)
    payload = jnp.where(live, payload, 0)
    nbits = max(L - 1, 1).bit_length()
    return _pair_compact_or_xla(carrier, payload, nbits)


def region_words_f32(length, res):
    """Assemble the residual byte region as big-endian u32 words, on device.

    length: (C, L) int32 in 0..4 — emitted bytes per value;
    res:    (C, L) uint32 — residual (low ``length`` bytes are emitted,
            big-endian).
    Returns (words (C, L) uint32 big-endian, n_res (C,) int32). Byte k of the
    region (k < n_res) is ``words[k >> 2] >> (8 * (3 - (k & 3)))``.
    """
    C, L = length.shape
    assert L % 4 == 0
    Lg = L // 4
    cum = _cumsum_l(length)
    off = cum - length  # exclusive prefix: byte offset of each value
    n_res = cum[:, -1]

    # left-aligned big-endian residual image (zeros below the live bytes)
    sh = (8 * (4 - jnp.maximum(length, 1))).astype(jnp.uint32)
    A = jnp.where(length > 0, res << sh, 0)

    A4 = A.reshape(C, Lg, 4)
    LEN4 = length.reshape(C, Lg, 4)
    OFF4 = off.reshape(C, Lg, 4)
    lo = OFF4 - OFF4[:, :, 0:1]  # group-local byte offset, 0..15
    gsize = jnp.sum(LEN4, axis=2)  # 0..16

    # group words: W[:, :, k] = bytes [4k, 4k+4) of the group's dense image
    # value j's top byte lands at group-local byte lo_j, i.e. at byte position
    # lo_j - 4k (0 = MSB) of word k: shift right by 8*(lo_j - 4k) when the
    # value starts inside/after the word, left by 8*(4k - lo_j) otherwise
    k4 = jnp.arange(4, dtype=jnp.int32)
    delta = 4 * k4[None, None, :, None] - lo[:, :, None, :]  # (C, Lg, k, j)
    sr = (8 * jnp.clip(-delta, 0, 3)).astype(jnp.uint32)
    sl = (8 * jnp.clip(delta, 0, 3)).astype(jnp.uint32)
    Ab = A4[:, :, None, :]
    piece = jnp.where(delta <= 0, Ab >> sr, Ab << sl)
    overlap = (delta > -4) & (delta < LEN4[:, :, None, :])
    # Invariant: each byte of the group's dense image comes from exactly one
    # value (the `overlap` mask keeps only value j's own length_j bytes, and
    # offsets partition the image), so the pieces are bitwise-disjoint and
    # sum equals bitwise-OR with no carries.
    W = jnp.sum(jnp.where(overlap, piece, 0), axis=3, dtype=jnp.uint32)

    og = OFF4[:, :, 0]  # group start byte offset (C, Lg)
    r = (og & 3).astype(jnp.uint32)  # residue within dest word, per group
    c0 = W >> (8 * r)[:, :, None]
    c1 = jnp.where((r > 0)[:, :, None], W << (8 * (4 - r) % 32)[:, :, None], 0)
    dword = ((og[:, :, None] + 4 * k4[None, None, :]) >> 2).astype(jnp.int32)
    live = 4 * k4[None, None, :] < gsize[:, :, None]

    c0 = c0.reshape(C, L)
    c1 = c1.reshape(C, L)
    dword = dword.reshape(C, L)
    live = live.reshape(C, L)

    T0 = _pair_compact_or(dword, c0, live, L)
    T1 = _pair_compact_or(dword + 1, c1, live & (c1 != 0), L)
    return T0 | T1, n_res


def region_bytes_f32(length, res):
    """(C, L) (length, res) → ((C, 4L) uint8 region bytes, (C,) n_res)."""
    C, L = length.shape
    words, n_res = region_words_f32(length, res)
    sh = jnp.uint32(8) * (3 - jnp.arange(4, dtype=jnp.uint32))[None, None, :]
    b = ((words[:, :, None] >> sh) & 0xFF).astype(jnp.uint8).reshape(C, 4 * L)
    pos = jnp.arange(4 * L, dtype=jnp.int32)[None, :]
    return jnp.where(pos < n_res[:, None], b, 0), n_res
