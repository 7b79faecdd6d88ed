"""BP32 bit-plane integer codec: oracle, device, native, container, archive.

BP32 (codec/bp_ref.py spec) replaces LZ4-byte-planes on index-like integer
streams when smaller. The reference has no equivalent — its integer path is
LZ4 whose decode is inherently sequential (lz4.c:1658); BP32 is the data-parallel
redesign with closed-form parallel decode on device (codec/bp_jax.py).
"""

import numpy as np
import pytest

from trico_tpu import chunked, native
from trico_tpu.codec import bp_jax, bp_ref

import jax.numpy as jnp


def _index_like(n, seed=0):
    """Clustered, locally-increasing values like triangle connectivity."""
    rng = np.random.default_rng(seed)
    base = np.repeat(rng.integers(0, 1 << 20, (n + 7) // 8), 8)[:n]
    return (base + rng.integers(0, 64, n)).astype(np.uint32)


@pytest.mark.parametrize("n", [1, 31, 32, 33, 4096, 10001])
@pytest.mark.parametrize("dt", [np.uint32, np.uint64])
def test_oracle_roundtrip(n, dt):
    rng = np.random.default_rng(n)
    v = rng.integers(0, 2 ** (dt().itemsize * 8 - 1), n, dtype=np.uint64).astype(dt)
    p = bp_ref.encode_chunk(v)
    assert len(p) == bp_ref.chunk_payload_size(v)
    got = bp_ref.decode_chunk(p, n, dt().itemsize * 8)
    np.testing.assert_array_equal(got, v)


@pytest.mark.parametrize("C,L", [(3, 64), (5, 256), (2, 4096)])
def test_jax_matches_oracle(C, L):
    v = _index_like(C * L, seed=C).reshape(C, L)
    pay, sz = bp_jax.encode_bp32_chunks(jnp.asarray(v))
    pay, sz = np.asarray(pay), np.asarray(sz)
    for c in range(C):
        assert pay[c, : sz[c]].tobytes() == bp_ref.encode_chunk(v[c])
    dec = np.asarray(bp_jax.decode_bp32_chunks(jnp.asarray(pay), L))
    np.testing.assert_array_equal(dec, v)


def test_jax_extreme_values():
    """Full-width deltas (random u32 bits) force 32-plane groups."""
    rng = np.random.default_rng(7)
    v = rng.integers(0, 2**32, (2, 256), dtype=np.uint64).astype(np.uint32)
    pay, sz = bp_jax.encode_bp32_chunks(jnp.asarray(v))
    for c in range(2):
        assert np.asarray(pay)[c, : np.asarray(sz)[c]].tobytes() == \
            bp_ref.encode_chunk(v[c])
    dec = np.asarray(bp_jax.decode_bp32_chunks(pay, 256))
    np.testing.assert_array_equal(dec, v)


@pytest.mark.parametrize("dt", [np.uint32, np.uint64])
def test_native_matches_oracle(dt):
    if not native.available():
        pytest.skip("native unavailable")
    rng = np.random.default_rng(3)
    v = rng.integers(0, 2 ** (dt().itemsize * 8 - 1), 10001,
                     dtype=np.uint64).astype(dt)
    chunks = native.bp_encode_blocks(v, 4096)
    for i, ch in enumerate(chunks):
        assert ch == bp_ref.encode_chunk(v[i * 4096 : (i + 1) * 4096])
    sizes = np.array([len(c) for c in chunks], np.int64)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    cnts = np.minimum(4096, len(v) - np.arange(len(chunks)) * 4096)
    out = native.bp_decode_blocks(b"".join(chunks), offs, sizes, cnts,
                                  dt().itemsize)
    np.testing.assert_array_equal(out, v)


@pytest.mark.parametrize("n", [0, 100, 16384, 40000])
@pytest.mark.parametrize("dt", [np.uint32, np.uint64])
def test_container_roundtrip(n, dt):
    v = _index_like(n).astype(dt)
    blob = chunked.encode_bp_chunked(v)
    hdr = chunked.parse_container_header(blob)
    assert hdr is not None and hdr.kind == "bp"
    assert hdr.bits == dt().itemsize * 8
    for use_tpu in (True, False):
        out = chunked.decode_bp_chunked(blob, use_tpu=use_tpu)
        assert out.dtype == dt
        np.testing.assert_array_equal(out, v)


def test_container_host_device_identical():
    v = _index_like(40000)
    a = chunked.encode_bp_chunked(v, use_tpu=True)
    b = chunked.encode_bp_chunked(v, use_tpu=False)
    assert a == b


def test_container_truncation_rejected():
    v = _index_like(16384)
    blob = chunked.encode_bp_chunked(v)
    with pytest.raises(ValueError):
        chunked.decode_bp_chunked(blob[: len(blob) // 2], use_tpu=False)
    # flipping a width byte to an impossible value must raise, not crash
    bad = bytearray(blob)
    bad[14 + 4 * 1] = 77  # width > 32 inside chunk 0's header region
    with pytest.raises(ValueError):
        chunked.decode_bp_chunked(bytes(bad), use_tpu=False)


def test_int_best_picks_bp_for_indices_and_lz4_for_colors(bunny_triangles):
    tris = bunny_triangles
    subs = chunked.encode_int_best(tris)
    assert chunked.parse_container_header(subs[0]).kind == "bp"
    # archive-level: smaller than forcing LZ4 planes
    from trico_tpu.codec import transpose

    lz4_total = sum(len(chunked.encode_lz4_chunked(p))
                    for p in transpose.byte_planes(tris))
    assert sum(len(s) for s in subs) < lz4_total

    rng = np.random.default_rng(0)
    colors = rng.choice(
        np.array([0xFF0000FF, 0xFF00FF00, 0x12345678], np.uint32), 50000
    ).astype(np.uint32)
    subs_c = chunked.encode_int_best(colors)
    assert chunked.parse_container_header(subs_c[0]).kind == "lz4"


def test_v1_archive_bp_streams(bunny_vertices, bunny_triangles):
    from trico_tpu.archive import ArchiveReader, ArchiveWriter

    w = ArchiveWriter(chunk_len=4096)
    w.write_vertices(bunny_vertices)
    w.write_triangles(bunny_triangles)
    blob = w.tobytes()
    r = ArchiveReader(blob)
    np.testing.assert_array_equal(
        r.read_vertices().view(np.uint32), bunny_vertices.view(np.uint32))
    np.testing.assert_array_equal(r.read_triangles(), bunny_triangles)


def test_sharded_bp_decode(bunny_triangles):
    import jax

    from trico_tpu.parallel import mesh_codec

    mesh = mesh_codec.make_mesh(min(4, len(jax.devices())))
    flat = bunny_triangles.reshape(-1).astype(np.uint32)
    blob = chunked.encode_bp_chunked(flat)
    out = mesh_codec.decode_bp_sharded(blob, mesh)
    np.testing.assert_array_equal(out, flat)


def test_compress_mesh_uses_bp_and_roundtrips(bunny_vertices, bunny_triangles):
    import jax

    from trico_tpu.parallel import mesh_codec

    mesh = mesh_codec.make_mesh(min(4, len(jax.devices())))
    blob = mesh_codec.compress_mesh(bunny_vertices, bunny_triangles, mesh=mesh)
    out = mesh_codec.decompress_mesh(blob, mesh=mesh)
    np.testing.assert_array_equal(
        out["vertices"].view(np.uint32), bunny_vertices.view(np.uint32))
    np.testing.assert_array_equal(out["triangles"], bunny_triangles)


def test_bp64_jax_matches_oracle():
    rng = np.random.default_rng(11)
    C, L = 2, 512
    v = rng.integers(0, 2**64, C * L, dtype=np.uint64)
    v[::5] = np.cumsum(rng.integers(0, 9, C * L))[::5].astype(np.uint64)
    v = v.reshape(C, L)
    hi = (v >> np.uint64(32)).astype(np.uint32)
    lo = (v & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    pay, sz = bp_jax.encode_bp64_chunks(jnp.asarray(hi), jnp.asarray(lo))
    pay, sz = np.asarray(pay), np.asarray(sz)
    for c in range(C):
        assert pay[c, : sz[c]].tobytes() == bp_ref.encode_chunk(v[c])
    dh, dl = bp_jax.decode_bp64_chunks(jnp.asarray(pay), L)
    back = ((np.asarray(dh).astype(np.uint64) << np.uint64(32))
            | np.asarray(dl).astype(np.uint64))
    np.testing.assert_array_equal(back, v)


def test_bp64_container_device_matches_host():
    v = _index_like(3 * 512 + 77).astype(np.uint64) * np.uint64(0x100000001)
    a = chunked.encode_bp_chunked(v, chunk_len=512, use_tpu=True)
    b = chunked.encode_bp_chunked(v, chunk_len=512, use_tpu=False)
    assert a == b
    for use_tpu in (True, False):
        out = chunked.decode_bp_chunked(a, use_tpu=use_tpu)
        np.testing.assert_array_equal(out, v)


def test_bp64_sharded_decode():
    import jax

    from trico_tpu.parallel import mesh_codec

    mesh = mesh_codec.make_mesh(min(4, len(jax.devices())))
    v = _index_like(6 * 512 + 31).astype(np.uint64) * np.uint64(3_000_000_017)
    blob = chunked.encode_bp_chunked(v, chunk_len=512)
    out = mesh_codec.decode_bp_sharded(blob, mesh)
    assert out.dtype == np.uint64
    np.testing.assert_array_equal(out, v)
