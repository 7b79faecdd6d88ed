"""Chunked FP substream container — the v1 format extension for parallel codecs.

A version-1 trico-tpu archive replaces each plain FP substream payload with:

``[u8 container_version=1][u8 flags][u32 LE chunk_len][u32 LE total_count]``
``[u32 LE n_chunks][n_chunks x u32 LE chunk_size][concatenated chunk payloads]``

flags bit 0: element width (0 = f32/u32, 1 = f64/u64).
flags bit 1: payload kind (set = chunked LZ4 container, see encode_lz4_chunked).
flags bit 2: chunk layout (0 = reference layout, 1 = "tpu" v2 layout: same
bytes with the group tags front-loaded — fp_jax.pack_f32_chunks_v2 — so decode
is gather-free on the device). The final partial chunk, if any, always uses the
reference layout (it is host-coded either way); relayout is a pure byte
permutation, so sizes are identical across layouts.
flags bit 3: BP32/64 bit-plane integer container (FORMAT.md §6,
codec/bp_ref.py) — the device integer codec, picked per stream when
smaller than LZ4 byte planes (encode_int_best).
flags == 10 (bits 1+3 together): "fill" container — the whole plane is one
repeated byte: ``[u8 1][u8 10][u32 total][u32 total][u32 1][u32 1][u8 value]``
(19 bytes regardless of length). Constant byte planes are common (upper
index planes when ids < 2^24, 0xFF alpha planes) and LZ4 fundamentally
costs ~n/255 on them (match-length extension bytes, lz4.c:207-210); this
kind makes them free. Emitted per plane by encode_int_best.

Every chunk payload holds ``chunk_len`` values (final chunk: the remainder)
with a standard FP substream header (hash_info byte, big-endian count — see
fp_ref.py); reference-layout chunks are verbatim reference FP substreams.
Chunks are independent codec instances, so encode and decode are
embarrassingly parallel across chunks — this is what the device codecs
(fp_jax.py) and the multi-chip path (trico_tpu/parallel) exploit. The framing
is self-describing and skippable, preserving the archive property that any
stream can be skipped without decoding (SURVEY.md §5 checkpoint/resume notes).

Warm-up cost: each chunk restarts its predictor tables, costing a little ratio
(measured ~2-4% on mesh data at chunk_len=4096) — the same trade the reference
already makes per substream.
"""

from __future__ import annotations

import struct

import numpy as np

from .codec import fp_ref

DEFAULT_CHUNK_LEN = 4096
# Chunked-mode hash exponents: e2=6 costs ~0.4% ratio vs (4,10) on mesh data
# (and is byte-identical on the bench stream) but keeps the one-hot DFCM
# replay table at 64 rows (replay cost is linear in the table height).
# Self-describing via each chunk's hash_info byte.
F32_TPU_EXP = (4, 6)


def _tpu_available() -> bool:
    """True when JAX's default device is an accelerator (a GPU). A backend
    that fails to start, or a platform with no route, raises."""
    from .codec import fp_jax

    fp_jax.kernel_route()  # raises on a platform with no route
    import jax

    return jax.devices()[0].platform != "cpu"


def _host_fp_encode(vals, e1, e2):
    from . import native

    if native.available():
        return native.fp_encode(vals, e1, e2)
    return fp_ref.compress(vals, e1, e2)


def _relayout_payload(payload: bytes, bits: int, to_v2: bool) -> bytes:
    """Single-payload v1<->v2 relayout: native (threaded memcpy walk) when
    available, NumPy helper otherwise."""
    from . import native

    buf = np.frombuffer(payload, np.uint8)
    if native.available():
        return native.relayout_chunks(buf[None, :], _payload_count(buf, bits),
                                      bits, to_v2)[0].tobytes()
    from .codec import fp64_jax, fp_jax

    if bits == 32:
        fn = fp_jax.relayout_f32_v1_to_v2 if to_v2 else fp_jax.relayout_f32_v2_to_v1
    else:
        fn = fp64_jax.relayout_f64_v1_to_v2 if to_v2 else fp64_jax.relayout_f64_v2_to_v1
    return fn(buf).tobytes()


class ContainerHeader:
    """Parsed v1 chunked-container header (the 15-byte fixed prefix)."""

    __slots__ = ("bits", "kind", "layout", "chunk_len", "total", "n_chunks")

    def __init__(self, bits, kind, layout, chunk_len, total, n_chunks):
        self.bits = bits            # 32 | 64
        self.kind = kind            # "fp" | "lz4" | "bp"
        self.layout = layout        # "ref" | "tpu"
        self.chunk_len = chunk_len
        self.total = total
        self.n_chunks = n_chunks


def parse_container_header(payload) -> ContainerHeader | None:
    """Parse a v1 chunked-container prefix, or None if ``payload`` is not one.

    This is the one place that interprets the flags byte — dispatchers must
    route on the parsed fields, not on raw payload bytes (a new flags bit
    would silently break byte sniffing)."""
    buf = memoryview(payload)
    if len(buf) < 14 or buf[0] != 1:
        return None
    flags = buf[1]
    chunk_len, total, n_chunks = struct.unpack_from("<III", buf, 2)
    if flags == 10:
        # bits 1+3 together = "fill": one repeated byte for the whole plane
        return ContainerHeader(bits=32, kind="fill", layout="ref",
                               chunk_len=chunk_len, total=total,
                               n_chunks=n_chunks)
    if flags & ~15 or (flags & 2 and flags & 8):
        return None  # unknown flag bits / contradictory kind: not ours
    return ContainerHeader(
        bits=64 if flags & 1 else 32,
        kind="bp" if flags & 8 else ("lz4" if flags & 2 else "fp"),
        layout="tpu" if flags & 4 else "ref",
        chunk_len=chunk_len, total=total, n_chunks=n_chunks)


def parse_validated_framing(data: bytes) -> tuple[ContainerHeader, tuple, int]:
    """Parse + bounds-validate a v1 container's framing from untrusted bytes.

    Returns ``(header, sizes, payload_offset)`` or raises ``ValueError`` —
    the single place every decoder (host and sharded) gets its chunk sizes
    from, so a crafted archive can never drive out-of-bounds reads/writes in
    the native row movers (ADVICE r4 high; reference error model:
    trico/trico.c:71-72). Checks: fixed prefix present, version 1, a nonzero
    chunk length, the size table and the payload bytes inside the buffer,
    and the chunk count consistent with the declared total (an undersized
    count would silently leave np.empty garbage in the decoded tail —
    ADVICE r4 medium)."""
    if len(data) < 14:
        raise ValueError("truncated chunked container")
    ver, flags, chunk_len, total, n_chunks = struct.unpack_from("<BBIII", data, 0)
    if ver != 1:
        raise ValueError(f"unsupported chunked container version {ver}")
    hdr = parse_container_header(data)
    if hdr is None:
        raise ValueError("corrupt chunked container flags")
    if chunk_len == 0:
        raise ValueError("corrupt chunked container: zero chunk length")
    off = 14
    if off + 4 * n_chunks > len(data):
        raise ValueError("truncated chunked container")
    sizes = struct.unpack_from(f"<{n_chunks}I", data, off)
    off += 4 * n_chunks
    if off + sum(sizes) > len(data):
        raise ValueError("truncated chunked container")
    expected = (total + chunk_len - 1) // chunk_len
    # legacy LZ4 empty-stream containers carry one empty block for total=0
    ok = (n_chunks == expected or
          (hdr.kind == "lz4" and total == 0 and n_chunks <= 1))
    if not ok:
        raise ValueError("corrupt chunked container: chunk count does not "
                         "match declared element total")
    return hdr, sizes, off


def rows_to_bytes(mat: np.ndarray, sizes) -> np.ndarray:
    """Concatenate the first ``sizes[c]`` bytes of every row of a padded
    (C, B) payload matrix into one contiguous uint8 array — the vectorized
    replacement for ``b"".join(mat[c, :sizes[c]] for c)`` (a Python loop
    that was ~10k iterations/plane at Lucy scale, VERDICT r3 weak #4).
    Native threaded memcpy walk (~memory bandwidth); NumPy masked-gather
    fallback (~0.4 GB/s) when the toolchain is unavailable."""
    from . import native

    mat = np.ascontiguousarray(mat, np.uint8)
    sizes = np.asarray(sizes, np.int64)
    if native.available():
        lib = native.get_lib()
        dst_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        out = np.empty(int(sizes.sum()), np.uint8)
        lib.tt_rows_to_bytes(native._ptr(mat), mat.shape[0], mat.shape[1],
                             native._ptr(sizes), native._ptr(dst_off),
                             native._ptr(out))
        return out
    mask = np.arange(mat.shape[1], dtype=np.int64)[None, :] < sizes[:, None]
    return mat[mask]  # row-major boolean gather == concatenation in order


def bytes_to_rows(buf: np.ndarray, sizes, B: int) -> np.ndarray:
    """Inverse of :func:`rows_to_bytes`: scatter concatenated payloads into a
    zero-padded (C, B) matrix (row c gets ``sizes[c]`` bytes).

    ``sizes`` come from untrusted container framing, so they are validated
    here (not only at call sites): a row size above ``B`` or a total above
    ``len(buf)`` would make the native ``tt_bytes_to_rows`` memcpy past its
    row / source buffer (ADVICE r4 high). The reference decoder bounds-checks
    every read the same way (trico/trico.c:71-72)."""
    from . import native

    sizes = np.asarray(sizes, np.int64)
    buf = np.ascontiguousarray(buf, np.uint8)
    if len(sizes) and (sizes.min() < 0 or sizes.max() > B):
        raise ValueError("corrupt container framing: chunk size exceeds "
                         "the maximum payload bound")
    if int(sizes.sum()) != len(buf):
        raise ValueError("corrupt container framing: payload bytes do not "
                         "match declared chunk sizes")
    if native.available():
        lib = native.get_lib()
        src_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
        mat = np.empty((len(sizes), B), np.uint8)
        lib.tt_bytes_to_rows(native._ptr(buf), native._ptr(src_off),
                             native._ptr(sizes), len(sizes), B,
                             native._ptr(mat))
        return mat
    mat = np.zeros((len(sizes), B), np.uint8)
    mask = np.arange(B, dtype=np.int64)[None, :] < sizes[:, None]
    mat[mask] = buf
    return mat


def _payload_count(buf: np.ndarray, bits: int) -> int:
    n = int.from_bytes(buf[1:5].tobytes(), "big")
    group = 8 if bits == 32 else 2
    return ((n + group - 1) // group) * group


def _host_fp_decode(payload, bits):
    from . import native

    if native.available():
        return native.fp_decode(payload, bits)
    return fp_ref.decompress_f32(payload) if bits == 32 else fp_ref.decompress_f64(payload)


def host_decode_full_chunks(mat: np.ndarray, sizes_arr, idx, chunk_len: int,
                            bits: int, layout: str) -> np.ndarray:
    """Host decode of the full chunks ``mat[idx]`` → (len(idx), chunk_len)
    raw words: threaded native decoder when built, per-chunk pure oracle
    otherwise. ``sizes_arr`` aligns with ``mat`` rows; "tpu"-layout payloads
    are relaid out to the reference chunk layout first (a byte permutation —
    sizes are unchanged). Shared by :func:`decode_chunked` and
    ``mesh_codec.decode_plane_sharded`` so the two big-table-exponent
    fallbacks cannot drift apart."""
    from . import native

    B = mat.shape[1]
    if native.available():
        sub = mat[idx]
        if layout == "tpu":
            sub = native.relayout_chunks(sub, chunk_len, bits, to_v2=False)
        return native.fp_decode_blocks(
            sub.reshape(-1),
            np.arange(len(idx), dtype=np.int64) * B,
            np.asarray(sizes_arr, np.int64)[idx],
            np.full(len(idx), chunk_len, np.int64), bits,
        ).reshape(len(idx), chunk_len)
    rows = []
    for c in idx:
        p1 = mat[c, : sizes_arr[c]]
        if layout == "tpu":
            p1 = np.frombuffer(
                _relayout_payload(p1.tobytes(), bits, to_v2=False), np.uint8)
        rows.append(_host_fp_decode(p1, bits))
    return np.stack(rows)


def _host_fp_encode_best(vals, candidates) -> bytes:
    """Host encode with the smallest payload over the candidate exponents
    (first strictly-smaller wins — same tie rule as the device argmin)."""
    best = None
    for e1, e2 in candidates:
        p = _host_fp_encode(vals, e1, e2)
        if best is None or len(p) < len(best):
            best = p
    return best


def encode_chunked(values: np.ndarray, chunk_len: int = DEFAULT_CHUNK_LEN,
                   e1: int | None = None, e2: int | None = None,
                   use_tpu: bool | None = None, layout: str = "ref",
                   optimize: bool | str = False) -> bytes:
    """Encode a uint32/uint64 raw-bits stream into a chunked container.

    f32 full chunks go through the device path (``fp_jax``) when a GPU JAX
    backend is available (or when ``use_tpu=True``); everything else uses the
    host codec. Output bytes are identical either way for a given ``layout``
    ("ref" = reference chunk layout; "tpu" = v2 tags-first layout, the fast
    gather-free device decode path — both widths).

    ``optimize=True`` picks each chunk's hash exponents adaptively from
    ``fp_jax.F32_TPU_CANDIDATES`` / ``fp64_jax.F64_TPU_CANDIDATES`` — one
    device program, exact sizes from the bcodes, no extra host encodes;
    chunks stay self-describing via their hash_info byte, so any decoder
    handles the mix. ``optimize="fast"`` restricts the search to the
    small-table ``*_FAST`` candidate sets (full-rate device encode, every
    chunk device-decodable; the CLI ``--fast`` profile).
    """
    if values.dtype == np.uint32:
        bits = 32
        if e1 is None:
            e1, e2 = F32_TPU_EXP
    elif values.dtype == np.uint64:
        bits = 64
        if e1 is None:
            e1, e2 = 20, 20
    else:
        raise TypeError(values.dtype)
    if layout not in ("ref", "tpu"):
        raise ValueError(f"unknown layout {layout!r}")
    if bits == 32:
        chunk_len = (chunk_len // 8) * 8 or 8
    else:
        # even chunks: the v2 f64 pack works in 2-value groups. Rounding here
        # (before n_chunks) keeps every downstream path consistent — the device
        # branch previously rounded after n_chunks was computed, so an odd
        # chunk_len falling through to the host loop dropped tail values.
        chunk_len = (chunk_len // 2) * 2 or 2
    n = len(values)
    n_chunks = max((n + chunk_len - 1) // chunk_len, 0)
    from .codec.fp_jax import F32_TPU_CANDIDATES, F32_TPU_CANDIDATES_FAST

    # optimize="fast": throughput profile — only small-table candidates, so
    # every chunk decodes on the device (archives a few % larger; still
    # self-describing)
    if bits == 32:
        opt_cands = (F32_TPU_CANDIDATES_FAST if optimize == "fast"
                     else F32_TPU_CANDIDATES)
    else:
        from .codec.fp64_jax import (F64_TPU_CANDIDATES,
                                     F64_TPU_CANDIDATES_FAST)

        opt_cands = (F64_TPU_CANDIDATES_FAST if optimize == "fast"
                     else F64_TPU_CANDIDATES)

    payloads: list[bytes] = []
    if n >= chunk_len:
        if use_tpu is None:
            use_tpu = _tpu_available()
        if use_tpu:
            from . import native

            if bits == 32:
                from .codec import fp_jax

                if optimize:
                    mat, sizes, tail = fp_jax.encode_f32_adaptive(
                        values, chunk_len, opt_cands, layout=layout)
                else:
                    mat, sizes, tail = fp_jax.encode_f32(values, chunk_len, e1, e2,
                                                         layout=layout)
            elif native.available() or layout == "tpu":
                from .codec import fp64_jax

                if optimize and layout == "tpu":
                    mat, sizes, tail = fp64_jax.encode_f64_adaptive(
                        values, chunk_len, opt_cands)
                elif optimize:
                    # ref-layout adaptive: host per-chunk best-of (below)
                    mat, sizes, tail = None, None, None
                else:
                    mat, sizes, tail = fp64_jax.encode_f64(values, chunk_len,
                                                           e1, e2, layout=layout)
            else:
                mat, sizes, tail = None, None, None
            if sizes is not None:
                # vectorized masked gather, not a per-chunk Python loop
                chunk_sizes = [int(s) for s in sizes]
                body = [rows_to_bytes(mat, sizes).tobytes()]
                if len(tail):
                    tp = (_host_fp_encode_best(tail, opt_cands)
                          if optimize else _host_fp_encode(tail, e1, e2))
                    chunk_sizes.append(len(tp))
                    body.append(tp)
                flags = (0 if bits == 32 else 1) | (4 if layout == "tpu" else 0)
                head = struct.pack("<BBIII", 1, flags, chunk_len, n,
                                   len(chunk_sizes))
                sizes_blob = struct.pack(f"<{len(chunk_sizes)}I", *chunk_sizes)
                return head + sizes_blob + b"".join(body)
    if not payloads:
        for i in range(n_chunks):
            vals_i = values[i * chunk_len : (i + 1) * chunk_len]
            if optimize:
                p = _host_fp_encode_best(vals_i, opt_cands)
            else:
                p = _host_fp_encode(vals_i, e1, e2)
            full = (i + 1) * chunk_len <= n
            if layout == "tpu" and full:
                p = _relayout_payload(p, bits, to_v2=True)
            payloads.append(p)

    flags = (0 if bits == 32 else 1) | (4 if layout == "tpu" else 0)
    head = struct.pack("<BBIII", 1, flags, chunk_len, n, len(payloads))
    sizes_blob = struct.pack(f"<{len(payloads)}I", *[len(p) for p in payloads])
    return head + sizes_blob + b"".join(payloads)


# 1 MiB blocks: LZ4's match window is 64 KiB, so block independence costs
# only the first-64-KiB warm-up per block — measured within 1-2% of a
# whole-plane scan on every corpus index stream, vs +70-400% at the old
# 16 KiB (corpus gate r5). Decode parallelism is unaffected for real
# streams (Lucy-class planes still span ~80 blocks).
DEFAULT_LZ4_BLOCK = 1 << 20


def encode_fill(value: int, total: int) -> bytes:
    """A "fill" container: ``total`` copies of one byte in 19 bytes."""
    return struct.pack("<BBIII", 1, 10, total, total, 1) \
        + struct.pack("<I", 1) + bytes([value])


def decode_fill(data) -> np.ndarray:
    data = bytes(data)
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind != "fill":
        raise ValueError("not a fill container")
    if sizes != (1,) or hdr.chunk_len != hdr.total:
        raise ValueError("corrupt fill container")
    return np.full(hdr.total, data[off], np.uint8)


def encode_lz4_chunked(plane: np.ndarray, block_len: int = DEFAULT_LZ4_BLOCK,
                       use_tpu: bool | None = None) -> bytes:
    """Chunked-LZ4 container: independent LZ4 blocks of ``block_len`` bytes.

    flags byte = 2 distinguishes it from FP containers. Device match search
    (lz4_jax) for full blocks when a GPU backend is up; host codec otherwise.
    Blocks decode independently → parallel/resumable integer streams.
    """
    from . import native

    plane = np.ascontiguousarray(plane, dtype=np.uint8).reshape(-1)
    n = len(plane)
    if use_tpu is None:
        use_tpu = _tpu_available()
    payloads: list[bytes] = []
    if use_tpu and native.available() and n >= block_len:
        from .codec import lz4_jax

        payloads = lz4_jax.compress_plane(plane, block=block_len)
    elif native.available() and n > 0:
        # independent blocks compress across hardware threads (the encode
        # mirror of tt_lz4_decompress_blocks)
        payloads = native.lz4_compress_blocks(plane, block_len)
    else:
        comp = native.lz4_compress if native.available() else (
            lambda d: __import__("trico_tpu.codec.lz4_ref", fromlist=["compress"]).compress(bytes(d))
        )
        for i in range(0, max(n, 1), block_len):
            blk = plane[i : i + block_len]
            if len(blk) or n == 0:
                payloads.append(comp(blk))
            if n == 0:
                break
    head = struct.pack("<BBIII", 1, 2, block_len, n, len(payloads))
    sizes_blob = struct.pack(f"<{len(payloads)}I", *[len(p) for p in payloads])
    return head + sizes_blob + b"".join(payloads)


DEFAULT_BP_CHUNK = 16384  # values per BP32 chunk (64 KiB of u32)


def encode_bp_chunked(values: np.ndarray, chunk_len: int = DEFAULT_BP_CHUNK,
                      use_tpu: bool | None = None) -> bytes:
    """BP32 chunked container (flags bit 3): bit-plane-packed zigzag deltas.

    The device integer codec (format: codec/bp_ref.py) — gather-free
    parallel decode, unlike the LZ4 token walk. u32 full chunks run on device
    when a GPU backend is up; u64 and tails use the threaded native codec.
    Chunks restart deltas from 0, so they decode independently."""
    from . import native

    values = np.ascontiguousarray(values)
    eb = values.dtype.itemsize
    if eb not in (4, 8):
        raise TypeError(values.dtype)
    if eb == 8:
        # BP64 device decode compacts 17-bit slot ids through the 32-bit
        # log-shift word (sbits(8L) + sbits(8L) <= 32 ⇒ L <= 8192)
        chunk_len = min(chunk_len, 8192)
    chunk_len = (chunk_len // 32) * 32 or 32
    n = len(values)
    payloads: list[bytes] = []
    C = n // chunk_len
    if use_tpu is None:
        use_tpu = _tpu_available()
    if use_tpu and C > 0 and (eb == 4 or chunk_len <= 8192):
        import jax.numpy as jnp

        from .codec import bp_jax

        full = values[: C * chunk_len].reshape(C, chunk_len)
        if eb == 4:
            mat, sizes = bp_jax.encode_bp32_chunks(jnp.asarray(full))
        else:
            hi = (full >> np.uint64(32)).astype(np.uint32)
            lo = (full & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            mat, sizes = bp_jax.encode_bp64_chunks(jnp.asarray(hi),
                                                   jnp.asarray(lo))
        mat, sizes = np.asarray(mat), np.asarray(sizes)
        payloads = [rows_to_bytes(mat, sizes).tobytes()]
        chunk_sizes = [int(s) for s in sizes]
        tail = values[C * chunk_len :]
        if len(tail):
            if native.available():
                tp = native.bp_encode_blocks(tail, chunk_len)[0]
            else:
                from .codec import bp_ref

                tp = bp_ref.encode_chunk(tail)
            chunk_sizes.append(len(tp))
            payloads.append(tp)
        flags = 8 | (1 if eb == 8 else 0)
        head = struct.pack("<BBIII", 1, flags, chunk_len, n, len(chunk_sizes))
        return head + struct.pack(f"<{len(chunk_sizes)}I", *chunk_sizes) \
            + b"".join(payloads)
    if native.available() and n:
        payloads = native.bp_encode_blocks(values, chunk_len)
    elif n:
        from .codec import bp_ref

        payloads = [bp_ref.encode_chunk(values[s : s + chunk_len])
                    for s in range(0, n, chunk_len)]
    flags = 8 | (1 if eb == 8 else 0)
    head = struct.pack("<BBIII", 1, flags, chunk_len, n, len(payloads))
    sizes_blob = struct.pack(f"<{len(payloads)}I", *[len(p) for p in payloads])
    return head + sizes_blob + b"".join(payloads)


def decode_bp_chunked(data, use_tpu: bool | None = None) -> np.ndarray:
    """Decode a BP32 chunked container → flat u32/u64 array."""
    from . import native

    data = bytes(data)
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind != "bp":
        raise ValueError("not a BP32 container")
    chunk_len, total, n_chunks = hdr.chunk_len, hdr.total, hdr.n_chunks
    eb = hdr.bits // 8
    dt = np.uint32 if eb == 4 else np.uint64
    if n_chunks == 0 or total == 0:
        return np.zeros(total, dt)
    counts = np.minimum(chunk_len,
                        total - chunk_len * np.arange(n_chunks, dtype=np.int64))
    if use_tpu is None:
        use_tpu = _tpu_available()
    n_full = n_chunks - 1 if total % chunk_len else n_chunks
    buf = np.frombuffer(data, np.uint8)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off
    if use_tpu and n_full > 0 and chunk_len % 32 == 0 \
            and (eb == 4 or chunk_len <= 8192):
        import jax.numpy as jnp

        from .codec import bp_jax

        B = (bp_jax.bp32_max_chunk_bytes(chunk_len) if eb == 4
             else bp_jax.bp64_max_chunk_bytes(chunk_len))
        mat = bytes_to_rows(buf[offsets[0] : offsets[n_full]],
                            np.asarray(sizes[:n_full], np.int64), B)
        validate_bp_chunk_headers(mat, np.asarray(sizes[:n_full], np.int64),
                                  chunk_len, eb * 8)
        out = np.empty(total, dt)
        if eb == 4:
            vals = np.asarray(
                bp_jax.decode_bp32_chunks(jnp.asarray(mat), chunk_len))
        else:
            vh, vl = bp_jax.decode_bp64_chunks(jnp.asarray(mat), chunk_len)
            vals = ((np.asarray(vh).astype(np.uint64) << np.uint64(32))
                    | np.asarray(vl).astype(np.uint64))
        out[: n_full * chunk_len] = vals.reshape(-1)
        for c in range(n_full, n_chunks):
            out[c * chunk_len : c * chunk_len + counts[c]] = _bp_host_decode(
                buf[offsets[c] : offsets[c + 1]], int(counts[c]), eb)
        return out
    if native.available():
        return native.bp_decode_blocks(buf, offsets[:-1],
                                       np.asarray(sizes, np.int64), counts, eb)
    from .codec import bp_ref

    out = np.empty(total, dt)
    for c in range(n_chunks):
        out[c * chunk_len : c * chunk_len + counts[c]] = bp_ref.decode_chunk(
            buf[offsets[c] : offsets[c + 1]], int(counts[c]), eb * 8)
    return out


def validate_bp_chunk_headers(mat: np.ndarray, sizes: np.ndarray,
                              chunk_len: int, width_bits: int) -> None:
    """Validate the per-chunk BP width headers of padded full-chunk rows
    before dispatching payloads to the device kernels.

    The host decoders (bp_ref/native) reject ``w > width_bits`` and
    truncated plane payloads, but the device bit-plane parse would feed
    corrupt widths as negative displacements into the monotone compaction
    and return silent garbage (ADVICE r4 low) — so mirror the native checks
    on the host first: every width ≤ ``width_bits`` and each chunk's
    declared payload size exactly ``n_groups + 4*sum(w)`` (bp_ref.py layout;
    BP64 planes are 32-bit words too)."""
    n_groups = chunk_len // 32
    widths = mat[:, :n_groups].astype(np.int64)
    if widths.size and int(widths.max()) > width_bits:
        raise ValueError("corrupt BP32 chunk: width exceeds element bits")
    if np.any(n_groups + 4 * widths.sum(axis=1) != sizes):
        raise ValueError("corrupt BP32 chunk: payload size does not match "
                         "width header")


def _bp_host_decode(payload, n, eb):
    from . import native

    if native.available():
        return native.bp_decode_blocks(payload, [0], [len(payload)], [n], eb)
    from .codec import bp_ref

    return bp_ref.decode_chunk(payload, n, eb * 8)


def encode_int_best(arr: np.ndarray, block_len: int | None = None,
                    use_tpu: bool | None = None) -> list[bytes]:
    """Integer stream → the smaller of LZ4-byte-planes and BP32, as the
    stream's substream payload list (always ``itemsize`` substreams, so
    archive framing and skip logic are unchanged).

    LZ4 wins on low-entropy repetitive data (colors); BP32 wins on
    index-like data (triangle connectivity: −6% on the bunny vs the
    reference scheme) and decodes gather-free on device. Self-describing
    via each container's flags byte — the reader dispatches per substream."""
    from .codec import transpose

    arr = np.ascontiguousarray(arr)
    # constant byte planes (zero upper index planes, 0xFF alpha) are 19-byte
    # fill containers — LZ4 would pay ~n/255 in match-length extensions
    lz4_subs = [
        encode_fill(int(plane[0]), len(plane))
        if len(plane) and not np.any(plane != plane[0])
        else encode_lz4_chunked(plane, block_len or DEFAULT_LZ4_BLOCK,
                                use_tpu=use_tpu)
        for plane in transpose.byte_planes(arr)]
    flat = arr.reshape(-1)
    if flat.dtype.itemsize in (4, 8):
        bp = encode_bp_chunked(flat, use_tpu=use_tpu)
        # empty BP32 placeholder containers keep the substream count fixed
        bit0 = 1 if flat.dtype.itemsize == 8 else 0
        placeholder = struct.pack("<BBIII", 1, 8 | bit0, DEFAULT_BP_CHUNK, 0, 0)
        bp_total = len(bp) + (arr.dtype.itemsize - 1) * len(placeholder)
        if bp_total < sum(len(s) for s in lz4_subs):
            return [bp] + [placeholder] * (arr.dtype.itemsize - 1)
    return lz4_subs


def decode_lz4_chunked(data) -> np.ndarray:
    from . import native
    from .codec import lz4_ref

    data = bytes(data)
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind == "fill":
        return decode_fill(data)
    if hdr.kind != "lz4":
        raise ValueError("not a chunked LZ4 container")
    block_len, total, n_blocks = hdr.chunk_len, hdr.total, hdr.n_chunks
    dst_sizes = np.minimum(
        block_len, total - block_len * np.arange(n_blocks, dtype=np.int64)
    )
    if native.available():
        # blocks are independent by construction — decode across host threads
        src_off = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64) + off
        return native.lz4_decompress_blocks(data, src_off, np.asarray(sizes), dst_sizes)
    out = np.empty(total, np.uint8)
    pos = 0
    for i in range(n_blocks):
        size = int(dst_sizes[i])
        payload = data[off + pos : off + pos + sizes[i]]
        pos += sizes[i]
        out[i * block_len : i * block_len + size] = np.frombuffer(
            lz4_ref.decompress(payload, size), np.uint8
        )
    return out


def decode_chunked(data, use_tpu: bool | None = None) -> tuple[np.ndarray, int]:
    """Decode a chunked container → (raw-bits array, bits)."""
    data = bytes(data)
    hdr, sizes, off = parse_validated_framing(data)
    if hdr.kind != "fp":
        raise ValueError(f"{hdr.kind} container passed to decode_chunked "
                         "(FP containers only)")
    chunk_len, total, n_chunks = hdr.chunk_len, hdr.total, hdr.n_chunks
    bits = hdr.bits
    layout = hdr.layout
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64) + off

    dt = np.uint32 if bits == 32 else np.uint64
    if n_chunks == 0:
        return np.zeros(0, dt), bits

    # full chunks (all but possibly the last) decode in parallel on device
    n_full = n_chunks - 1 if total % chunk_len or total == 0 else n_chunks
    out = np.empty(total, dtype=dt)
    if use_tpu is None:
        use_tpu = _tpu_available()
    from . import native

    if bits == 64 and layout == "ref":
        # the f64 reference-layout device path parses on the host natively
        use_tpu = use_tpu and native.available()
    if n_full > 0 and (use_tpu or layout == "tpu"):
        from .codec import fp64_jax, fp_jax

        if bits == 32:
            B = fp_jax.f32_max_chunk_bytes(chunk_len)
            dec, relayout = fp_jax.decode_f32, fp_jax.relayout_f32_v2_to_v1
        else:
            B = fp64_jax.f64_max_chunk_bytes(chunk_len)
            dec, relayout = fp64_jax.decode_f64, fp64_jax.relayout_f64_v2_to_v1
        buf = np.frombuffer(data, np.uint8)
        full_sizes = np.asarray(sizes[:n_full], np.int64)
        mat = bytes_to_rows(buf[offsets[0] : offsets[n_full]], full_sizes, B)
        if layout == "tpu" and not use_tpu:
            # host fallback: relayout chunks to reference order (batched native
            # when available), then host-decode
            if native.available():
                mat1 = native.relayout_chunks(mat, chunk_len, bits, to_v2=False)
                out[: n_full * chunk_len] = native.fp_decode_blocks(
                    mat1.reshape(-1),
                    np.arange(n_full, dtype=np.int64) * B, full_sizes,
                    np.full(n_full, chunk_len, np.int64), bits,
                )
            else:
                for c in range(n_full):
                    p1 = relayout(mat[c, : sizes[c]])
                    out[c * chunk_len : (c + 1) * chunk_len] = _host_fp_decode(p1, bits)
        else:
            # exponents are self-describing per chunk (hash_info byte);
            # group chunks by hash_info so mixed-exponent containers (the
            # adaptive-exponent encoder) decode correctly on the device path
            hash_infos = mat[:, 0]
            for hi in np.unique(hash_infos):
                idx = np.nonzero(hash_infos == hi)[0]
                e1 = (int(hi) >> 4) << 1
                e2 = (int(hi) & 15) << 1
                # predictor replay needs (2^e1 + 2^e2)-row one-hot tables on
                # device, at cost linear in the row count; past this bound the
                # independent chunks decode on host threads at C speed
                # instead (tt_fp*_decode_blocks), or — when the native
                # toolchain is unavailable — through the pure per-chunk host
                # oracle (the device program would materialize 2^e2-row
                # one-hot tables per scan step and run out of memory)
                if (1 << e1) + (1 << e2) > (1 << 12):
                    vals = host_decode_full_chunks(mat, sizes, idx, chunk_len,
                                                   bits, layout)
                else:
                    vals = dec(mat[idx], chunk_len, e1, e2, layout=layout)
                    vals = vals.reshape(len(idx), chunk_len)
                # vectorized scatter of whole chunks (fancy-index rows)
                out[: n_full * chunk_len].reshape(n_full, chunk_len)[idx] = vals
        start = n_full
    elif n_full > 0 and native.available():
        # pure-host decode: full chunks are independent -> hardware threads
        b = np.frombuffer(data, np.uint8)
        out[: n_full * chunk_len] = native.fp_decode_blocks(
            b, offsets[:n_full], np.asarray(sizes, np.int64)[:n_full],
            np.full(n_full, chunk_len, np.int64), bits,
        )
        start = n_full
    else:
        start = 0
    for c in range(start, n_chunks):
        vals = _host_fp_decode(
            np.frombuffer(data, np.uint8)[offsets[c] : offsets[c + 1]], bits
        )
        out[c * chunk_len : c * chunk_len + len(vals)] = vals
    return out, bits
