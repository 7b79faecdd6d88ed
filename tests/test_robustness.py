"""Failure-model tests: corrupt archives must raise, never crash or hang.

The reference's error model is return codes + asserts that compile out in
release builds, so corrupt archives can silently misbehave (SURVEY.md §5).
Here every decode path bounds-checks and raises ValueError/RuntimeError.
"""

import numpy as np
import pytest

from trico_tpu import chunked, native
from trico_tpu.archive import ArchiveReader, ArchiveWriter
from trico_tpu.codec import lz4_ref
from conftest import mesh_like_floats


def _archive(chunk_len=None):
    w = ArchiveWriter(chunk_len=chunk_len)
    verts = np.stack([mesh_like_floats(500, s) for s in (0, 1, 2)], axis=1)
    w.write_vertices(verts)
    w.write_triangles(np.random.default_rng(0).integers(0, 500, (300, 3)).astype(np.uint32))
    return bytearray(w.tobytes())


@pytest.mark.parametrize("chunk_len", [None, 256])
def test_truncated_archive_raises(chunk_len):
    """Every cut must either raise or (if the cut only removed bytes past the
    data actually read) decode to the exact original values — silent
    corruption is a failure."""
    blob = _archive(chunk_len)
    r0 = ArchiveReader(bytes(blob))
    verts0, tris0 = r0.read_vertices(), r0.read_triangles()
    for cut in (9, len(blob) // 2, len(blob) - 3):
        try:
            r = ArchiveReader(bytes(blob[:cut]))
            v = r.read_vertices()
            t = r.read_triangles()
        except Exception:
            continue  # detected — good
        assert np.array_equal(v.view(np.uint32), verts0.view(np.uint32)) and \
            np.array_equal(t, tris0), f"cut at {cut} decoded silently wrong"


def test_bitflip_in_lz4_stream_detected_or_consistent():
    """A flipped payload byte must either raise or change the decoded output
    (no byte of the format is dead); decoding to the original values from a
    corrupted stream would mean the codec ignores input bytes."""
    blob = _archive()
    r0 = ArchiveReader(bytes(blob))
    verts0, tris0 = r0.read_vertices(), r0.read_triangles()
    rng = np.random.default_rng(1)
    outcomes = {"raised": 0, "differs": 0}
    for _ in range(20):
        pos = int(rng.integers(len(blob) // 2, len(blob)))
        mut = bytearray(blob)
        mut[pos] ^= 0xFF
        try:
            r = ArchiveReader(bytes(mut))
            v = r.read_vertices()
            t = r.read_triangles()
        except Exception:
            outcomes["raised"] += 1
            continue
        same = (v.shape == verts0.shape and t.shape == tris0.shape
                and np.array_equal(v.view(np.uint32), verts0.view(np.uint32))
                and np.array_equal(t, tris0))
        assert not same, f"bit flip at {pos} was silently absorbed"
        outcomes["differs"] += 1
    assert sum(outcomes.values()) == 20


def test_lz4_ref_corrupt_offset():
    data = b"abcdabcdabcdabcd" * 100
    comp = bytearray(lz4_ref.compress(data))
    # force an invalid zero offset
    for i in range(len(comp)):
        mut = bytearray(comp)
        mut[i] = 0
        try:
            lz4_ref.decompress(bytes(mut), len(data))
        except (ValueError, IndexError):
            pass


@pytest.mark.skipif(not native.available(), reason="no native")
def test_native_fp_decode_truncated():
    vals = mesh_like_floats(1000).view(np.uint32)
    comp = native.fp_encode(vals, 4, 10)
    for cut in (4, 5, 20, len(comp) - 1):
        with pytest.raises((ValueError, RuntimeError)):
            native.fp_decode(comp[:cut], 32)


def test_chunked_container_bad_version():
    with pytest.raises(ValueError):
        chunked.decode_chunked(b"\x07\x00" + b"\x00" * 12)
    with pytest.raises(ValueError):
        chunked.decode_lz4_chunked(b"\x01\x00" + b"\x00" * 12)


def test_resumable_partial_decode():
    """Checkpoint/resume property: a reader can skip any prefix of streams and
    decode later ones independently — and chunked streams allow decoding
    later chunks without earlier ones (self-describing [size][payload])."""
    w = ArchiveWriter(chunk_len=128)
    v1 = np.stack([mesh_like_floats(1000, s) for s in (0, 1, 2)], axis=1)
    a2 = mesh_like_floats(700, 9)
    w.write_vertices(v1)
    w.write_attributes_float(a2)
    blob = w.tobytes()
    # resume: skip the first stream entirely, decode only the second
    r = ArchiveReader(blob)
    r.skip_next_stream()
    np.testing.assert_array_equal(r.read_attributes_float(), a2)


def test_deterministic_output():
    """Race-detection stand-in: encoding is bit-deterministic across runs and
    across backends (numpy vs native vs chunked device paths are separately
    verified; here: repeated runs byte-identical)."""
    verts = np.stack([mesh_like_floats(2000, s) for s in (3, 4, 5)], axis=1)
    blobs = set()
    for _ in range(3):
        w = ArchiveWriter()
        w.write_vertices(verts)
        blobs.add(w.tobytes())
    assert len(blobs) == 1


# ---------------------------------------------------------------------------
# sharded-decode hardening (VERDICT r4 #2 / ADVICE r4 high): the distributed
# decode entry points parse the same untrusted v1 framing as the host readers
# and must fail loudly on corrupt archives — never drive out-of-bounds moves
# in the native row movers. Reference error model: trico/trico.c:71-72.
#
# Tests that actually *jit* (shard_map compiles through jaxlib's MLIR
# bindings) are skipped in the sanitizer CI jobs: LD_PRELOADed ASan aborts
# inside jaxlib's nanobind __cxa_throw interceptor (a jaxlib/toolchain
# interaction, not our code). The framing-validation fuzz — the part that
# protects the native movers — still runs under ASan.
# ---------------------------------------------------------------------------

import os as _os

_jit_under_sanitizer = pytest.mark.skipif(
    _os.environ.get("TRICO_TPU_SANITIZE") == "1",
    reason="jaxlib MLIR bindings abort under LD_PRELOAD ASan on first jit")


def _mesh_and_blob():
    from trico_tpu.parallel import mesh_codec

    mesh = mesh_codec.make_mesh(8)
    verts = np.stack([mesh_like_floats(900, s) for s in (0, 1, 2)], axis=1)
    tris = np.random.default_rng(3).integers(0, 900, (500, 3)).astype(np.uint32)
    blob = mesh_codec.compress_mesh(verts, tris, chunk_len=128, mesh=mesh)
    return mesh, verts, tris, blob


@_jit_under_sanitizer
def test_decompress_mesh_truncation_fuzz():
    from trico_tpu.parallel import mesh_codec

    mesh, verts, tris, blob = _mesh_and_blob()
    for cut in (9, 20, 60, len(blob) // 3, len(blob) // 2, len(blob) - 5):
        try:
            out = mesh_codec.decompress_mesh(blob[:cut], mesh)
        except Exception:
            continue  # detected — good
        assert np.array_equal(out["vertices"].view(np.uint32),
                              verts.view(np.uint32)) \
            and np.array_equal(out["triangles"], tris), \
            f"cut at {cut} decoded silently wrong"


@_jit_under_sanitizer
def test_decompress_mesh_bitflip_fuzz():
    from trico_tpu.parallel import mesh_codec

    mesh, verts, tris, blob = _mesh_and_blob()
    rng_ = np.random.default_rng(4)
    for _ in range(24):
        pos = int(rng_.integers(8, len(blob)))
        mut = bytearray(blob)
        mut[pos] ^= 0xFF
        try:
            out = mesh_codec.decompress_mesh(bytes(mut), mesh)
        except Exception:
            continue
        same = (out["vertices"].shape == verts.shape
                and out["triangles"].shape == tris.shape
                and np.array_equal(out["vertices"].view(np.uint32),
                                   verts.view(np.uint32))
                and np.array_equal(out["triangles"], tris))
        assert not same, f"bit flip at {pos} silently absorbed"


def test_sharded_decode_oversized_chunk_size_rejected():
    """A declared chunk size above the payload bound must raise before any
    native memcpy sees it (ADVICE r4 high)."""
    import struct

    from trico_tpu.parallel import mesh_codec

    mesh = mesh_codec.make_mesh(8)
    vals = mesh_like_floats(1024, 7).view(np.uint32)
    cont = bytearray(chunked.encode_chunked(vals, 128, layout="tpu"))
    # first size entry lives at offset 14; inflate it past the container
    struct.pack_into("<I", cont, 14, 1 << 30)
    with pytest.raises(ValueError):
        mesh_codec.decode_plane_sharded(bytes(cont), mesh)
    with pytest.raises(ValueError):
        chunked.decode_chunked(bytes(cont))


def test_sharded_decode_chunk_count_mismatch_rejected():
    """An undersized chunk count passed framing before r5 and returned
    np.empty garbage in the tail (ADVICE r4 medium)."""
    import struct

    from trico_tpu.parallel import mesh_codec

    mesh = mesh_codec.make_mesh(8)
    vals = np.arange(4096, dtype=np.uint32)
    for cont, dec in (
        (chunked.encode_bp_chunked(vals, 512),
         lambda d: mesh_codec.decode_bp_sharded(d, mesh)),
        (chunked.encode_chunked(vals, 512, layout="tpu"),
         lambda d: mesh_codec.decode_plane_sharded(d, mesh)),
    ):
        mut = bytearray(cont)
        n_chunks = struct.unpack_from("<I", mut, 10)[0]
        assert n_chunks > 1
        struct.pack_into("<I", mut, 10, n_chunks - 1)
        with pytest.raises(ValueError):
            dec(bytes(mut))


def test_bp_width_corruption_rejected_on_device_path():
    """Corrupt width bytes must raise on the device dispatch too, not only in
    the host decoders (ADVICE r4 low)."""
    from trico_tpu.parallel import mesh_codec

    mesh = mesh_codec.make_mesh(8)
    vals = np.arange(2048, dtype=np.uint32)
    cont = bytearray(chunked.encode_bp_chunked(vals, 512))
    n_chunks = int.from_bytes(cont[10:14], "little")
    payload_off = 14 + 4 * n_chunks
    cont[payload_off] = 200  # first chunk's first group width
    with pytest.raises(ValueError):
        mesh_codec.decode_bp_sharded(bytes(cont), mesh)
    with pytest.raises(ValueError):
        chunked.decode_bp_chunked(bytes(cont), use_tpu=True)
    with pytest.raises(ValueError):
        chunked.decode_bp_chunked(bytes(cont), use_tpu=False)


def test_bytes_to_rows_bounds():
    buf = np.arange(10, dtype=np.uint8)
    with pytest.raises(ValueError):
        chunked.bytes_to_rows(buf, [4, 20], 16)  # size > B
    with pytest.raises(ValueError):
        chunked.bytes_to_rows(buf, [4, 4], 16)  # sum != len(buf)
    mat = chunked.bytes_to_rows(buf, [4, 6], 8)
    assert mat.shape == (2, 8) and mat[0, 0] == 0 and mat[1, 0] == 4


@_jit_under_sanitizer
def test_bp64_device_boundary_8192():
    """chunk_len == 8192 is the last BP64 device-decodable length; 8193+ and
    non-32-multiples must route to the host and stay exact (VERDICT r4 #7)."""
    import struct

    from trico_tpu.codec import bp_ref
    from trico_tpu.parallel import mesh_codec

    mesh = mesh_codec.make_mesh(8)
    rng_ = np.random.default_rng(5)
    vals = rng_.integers(0, 1 << 40, 3 * 8192 + 100).astype(np.uint64)
    # encoder clamps BP64 chunk_len to 8192 — verify, then decode on device
    cont = chunked.encode_bp_chunked(vals, 8193)
    hdr = chunked.parse_container_header(cont)
    assert hdr.chunk_len == 8192
    np.testing.assert_array_equal(
        mesh_codec.decode_bp_sharded(cont, mesh), vals)
    np.testing.assert_array_equal(chunked.decode_bp_chunked(cont), vals)
    # a foreign encoder could emit chunk_len > 8192: hand-assemble one and
    # confirm the sharded entry point host-routes it bit-exactly
    big = 8224  # multiple of 32, > 8192
    payloads = [bp_ref.encode_chunk(vals[s : s + big])
                for s in range(0, len(vals), big)]
    head = struct.pack("<BBIII", 1, 8 | 1, big, len(vals), len(payloads))
    cont2 = head + struct.pack(f"<{len(payloads)}I",
                               *[len(p) for p in payloads]) \
        + b"".join(payloads)
    np.testing.assert_array_equal(
        mesh_codec.decode_bp_sharded(cont2, mesh), vals)


def test_row_block_override_guarded(monkeypatch):
    """TRICO_TPU_V2_BLOCK_VALUES above the verified XLA budget must refuse
    instead of silently corrupting data (VERDICT r4 weak #6)."""
    from trico_tpu.codec import fp_jax

    monkeypatch.setenv("TRICO_TPU_V2_BLOCK_VALUES", str(1 << 25))
    with pytest.raises(ValueError):
        fp_jax._row_block(1024)
    monkeypatch.setenv("TRICO_TPU_V2_UNSAFE", "1")
    assert fp_jax._row_block(1024) == (1 << 25) // 1024
    monkeypatch.delenv("TRICO_TPU_V2_UNSAFE")
    monkeypatch.setenv("TRICO_TPU_V2_BLOCK_VALUES", str(1 << 21))
    assert fp_jax._row_block(1024) == (1 << 21) // 1024
