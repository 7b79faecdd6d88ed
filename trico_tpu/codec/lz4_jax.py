"""Device-parallel LZ4 match finding.

LZ4 emission is inherently sequential (the greedy parse walks the block), but
the expensive part — match *search* — is not. Division of labor:

* **Device** (this module): for every position of every block, find the best
  match candidate, using only sort and scan primitives (no gathers):
  - previous-occurrence of the 4-byte-window hash (one stable multi-operand
    ``lax.sort`` carrying position + window words, like the FP predictor);
    candidates are verified against the carried window, so no gathers;
  - offset-1 run candidates (RLE) with exact lengths via a reversed cummax
    over run boundaries — these are what make near-constant byte planes
    (e.g. high bytes of triangle indices) compress 100x.
* **Host** (native ``tt_lz4_emit``): walks each block once, re-verifies and
  *extends* the device candidates against the actual bytes (memcpy-speed),
  and emits standard LZ4 block sequences. Because candidates are verified on
  device and re-verified on host, a wrong candidate only costs ratio, never
  correctness.

Blocks are independent (the chunked-LZ4 container in trico_tpu/chunked.py),
so search runs data-parallel across blocks on the chunk/lane axis.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

@functools.partial(jax.jit, static_argnums=())
def find_matches(blocks: jax.Array):
    """blocks: (C, S) uint8 → (offset (C, S) int32, rle_len (C, S) int32).

    ``offset[c, p]`` is the distance to a verified previous occurrence of the
    4-byte window at p (0 = none). ``rle_len[c, p]`` is the exact length of
    the offset-1 run starting at p (0 if < 4).
    """
    C, S = blocks.shape
    b = blocks.astype(jnp.uint32)

    def shifted(k):
        return jnp.concatenate([b[:, k:], jnp.zeros((C, k), jnp.uint32)], axis=1)

    w4 = b | (shifted(1) << 8) | (shifted(2) << 16) | (shifted(3) << 24)
    h = (w4 * np.uint32(2654435761)) >> np.uint32(32 - 13)

    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (C, S))
    ks, ps, ws = jax.lax.sort((h, pos, w4), num_keys=1, is_stable=True)
    same = jnp.concatenate(
        [jnp.zeros((C, 1), dtype=bool), ks[:, 1:] == ks[:, :-1]], axis=1
    )
    prev_pos = jnp.concatenate([jnp.zeros((C, 1), jnp.int32), ps[:, :-1]], axis=1)
    prev_w4 = jnp.concatenate([jnp.zeros((C, 1), jnp.uint32), ws[:, :-1]], axis=1)
    verified = same & (prev_w4 == ws)
    off_sorted = jnp.where(verified, ps - prev_pos, 0)
    _, offset = jax.lax.sort((ps, off_sorted), num_keys=1, is_stable=True)

    # offset-1 runs: eq[p] = b[p] == b[p-1]; run length at p = distance to the
    # next position where eq is False (reverse cummin over boundary indices)
    eq = jnp.concatenate(
        [jnp.zeros((C, 1), dtype=bool), blocks[:, 1:] == blocks[:, :-1]], axis=1
    )
    idx = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (C, S))
    boundary = jnp.where(eq, S, idx)  # positions where the run breaks
    next_break = jax.lax.cummin(boundary[:, ::-1], axis=1)[:, ::-1]
    rle_len = jnp.maximum(next_break - idx, 0)
    rle_len = jnp.where(rle_len >= 4, rle_len, 0)
    return offset, rle_len


def find_matches_np(blocks: np.ndarray):
    """NumPy mirror of :func:`find_matches` (host fallback / oracle)."""
    C, S = blocks.shape
    offs = np.zeros((C, S), np.int32)
    rles = np.zeros((C, S), np.int32)
    for c in range(C):
        b = blocks[c].astype(np.uint32)
        w4 = b.copy()
        for k in (1, 2, 3):
            w4[:-k] |= b[k:] << (8 * k)
        h = ((w4 * np.uint32(2654435761)) >> np.uint32(32 - 13)).astype(np.uint32)
        order = np.argsort(h, kind="stable")
        hs = h[order]
        same = np.concatenate([[False], hs[1:] == hs[:-1]])
        prev_pos = np.concatenate([[0], order[:-1]])
        prev_w4 = np.concatenate([[0], w4[order][:-1]])
        ver = same & (prev_w4 == w4[order])
        off_sorted = np.where(ver, order - prev_pos, 0)
        off = np.zeros(S, np.int32)
        off[order] = off_sorted
        offs[c] = off
        eq = np.concatenate([[False], blocks[c][1:] == blocks[c][:-1]])
        boundary = np.where(eq, S, np.arange(S))
        next_break = np.minimum.accumulate(boundary[::-1])[::-1]
        rl = np.maximum(next_break - np.arange(S), 0)
        rles[c] = np.where(rl >= 4, rl, 0)
    return offs, rles


def compress_block_with_candidates(block: np.ndarray, offset: np.ndarray,
                                   rle_len: np.ndarray) -> bytes:
    """Host emission: candidates → a valid LZ4 block (native tt_lz4_emit)."""
    import ctypes

    from .. import native

    lib = native.get_lib()
    block = np.ascontiguousarray(block, dtype=np.uint8)
    n = len(block)
    cap = int(lib.tt_lz4_bound(n))
    out = np.empty(cap, np.uint8)
    sz = lib.tt_lz4_emit(
        block.ctypes.data_as(ctypes.c_void_p), n,
        np.ascontiguousarray(offset, np.int32).ctypes.data_as(ctypes.c_void_p),
        np.ascontiguousarray(rle_len, np.int32).ctypes.data_as(ctypes.c_void_p),
        out.ctypes.data_as(ctypes.c_void_p), cap,
    )
    if sz < 0:
        raise RuntimeError("lz4 emit failed")
    return out[:sz].tobytes()


def compress_plane(plane: np.ndarray, block: int = 4096):
    """Compress a byte plane as independent LZ4 blocks of `block` bytes.

    Returns a list of per-block LZ4 payloads (each independently decodable).
    Device does the match search for all full blocks at once; the host
    emitter walks them. The tail block uses the host's own matcher.
    """
    from .. import native

    plane = np.ascontiguousarray(plane, dtype=np.uint8).reshape(-1)
    n = len(plane)
    C = n // block
    if C == 0:
        return [native.lz4_compress(plane)] if n else []
    blocks = plane[: C * block].reshape(C, block)
    off, rle = find_matches(jnp.asarray(blocks))
    # one threaded native call emits every block (no per-block Python loop)
    return native.lz4_emit_blocks(
        blocks, np.asarray(off), np.asarray(rle),
        tail=plane[C * block:] if n % block else None)
