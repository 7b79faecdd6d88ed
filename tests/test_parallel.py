"""Multi-device (simulated multi-host) tests on the virtual 8-CPU mesh.

Scale-model of the BASELINE config "100M-point cloud sharded across N hosts:
chunked data-parallel encode, ordered gather, bit-exact decode".
"""

import jax
import numpy as np
import pytest

from trico_tpu.codec import fp_jax, fp_ref
from trico_tpu.parallel import mesh_codec
from conftest import mesh_like_floats

@pytest.fixture
def eight_devices():
    """Skip unless the backend has 8 devices — decided at run time, not at
    import, so every xdist worker collects the same tests."""
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")


needs8 = pytest.mark.usefixtures("eight_devices")


@needs8
def test_sharded_encode_matches_oracle():
    mesh = mesh_codec.make_mesh(8)
    L = 128
    planes = np.stack([
        mesh_like_floats(40 * L, seed=s).view(np.uint32) for s in (0, 1, 2)
    ])
    payloads, sizes, offsets, tails = mesh_codec.encode_planes(
        planes, chunk_len=L, mesh=mesh
    )
    assert payloads.shape[:2] == (3, 40)
    for p in range(3):
        for c in range(40):
            # sharded encode emits v2 tpu-layout payloads: byte-permutation of
            # the oracle's reference-layout output, identical size
            expect = fp_jax.relayout_f32_v1_to_v2(
                np.frombuffer(fp_ref.compress(planes[p, c * L : (c + 1) * L], 4, 10), np.uint8)
            ).tobytes()
            assert payloads[p, c, : sizes[p, c]].tobytes() == expect
    # offsets = exclusive scan in (plane, chunk) order → deterministic layout
    flat = sizes.reshape(-1)
    np.testing.assert_array_equal(
        offsets.reshape(-1), np.concatenate([[0], np.cumsum(flat)[:-1]])
    )


@needs8
def test_device_count_invariance():
    """The archive bytes must not depend on how many devices encoded them."""
    L = 128
    planes = np.stack([mesh_like_floats(24 * L, seed=9).view(np.uint32)])
    outs = []
    for n_dev in (1, 2, 8):
        mesh = mesh_codec.make_mesh(n_dev)
        payloads, sizes, _, _ = mesh_codec.encode_planes(planes, chunk_len=L, mesh=mesh)
        outs.append(b"".join(
            payloads[0, c, : sizes[0, c]].tobytes() for c in range(payloads.shape[1])
        ))
    assert outs[0] == outs[1] == outs[2]


@needs8
def test_roundtrip_step_on_mesh():
    mesh = mesh_codec.make_mesh(8)
    L = 64
    vals = np.stack([
        mesh_like_floats(16 * L, seed=s).view(np.uint32).reshape(16, L)
        for s in (0, 1, 2)
    ])
    import jax.numpy as jnp

    exact, total, offsets = jax.jit(
        lambda v: mesh_codec.roundtrip_step(v, L, mesh)
    )(jnp.asarray(vals))
    assert bool(exact)
    assert int(total) > 0


@needs8
def test_point_cloud_archive_sharded():
    """End-to-end point-cloud config: xyz f32 points → sharded chunk encode →
    chunked archive container bytes → bit-exact decode."""
    from trico_tpu import chunked

    n = 100_000  # scale model of the 100M config
    pts = np.stack([mesh_like_floats(n, seed=s) for s in (1, 2, 3)], axis=1)
    mesh = mesh_codec.make_mesh(8)
    planes = np.ascontiguousarray(pts.T).view(np.uint32).reshape(3, n)
    payloads, sizes, offsets, tails = mesh_codec.encode_planes(
        planes, chunk_len=4096, mesh=mesh
    )
    # ordered gather: assemble each plane's chunked container on host
    for p in range(3):
        parts = [payloads[p, c, : sizes[p, c]].tobytes() for c in range(payloads.shape[1])]
        if len(tails[p]):
            from trico_tpu.chunked import _host_fp_encode

            parts.append(_host_fp_encode(tails[p], 4, 10))
        import struct

        # flags bit 2: sharded encode_planes emits v2 tpu-layout chunks
        head = struct.pack("<BBIII", 1, 4, 4096, n, len(parts))
        sizes_blob = struct.pack(f"<{len(parts)}I", *[len(x) for x in parts])
        blob = head + sizes_blob + b"".join(parts)
        out, bits = chunked.decode_chunked(blob)
        np.testing.assert_array_equal(out, planes[p])


@needs8
def test_compress_mesh_produces_decodable_archive():
    """The distributed product (VERDICT r1 missing #2): mesh -> shard_map
    encode -> ordered gather -> v1 .trc bytes, decodable by ArchiveReader and
    bit-identical to the host ArchiveWriter output."""
    from trico_tpu.archive import ArchiveReader, ArchiveWriter

    n = 3000  # non-multiple of chunk_len: exercises the host tail chunk
    verts = np.stack([mesh_like_floats(n, seed=s) for s in (4, 5, 6)], axis=1)
    tris = np.random.default_rng(0).integers(0, n, (5000, 3)).astype(np.uint32)
    mesh = mesh_codec.make_mesh(8)
    blob = mesh_codec.compress_mesh(verts, tris, chunk_len=256, mesh=mesh)

    r = ArchiveReader(blob)
    np.testing.assert_array_equal(
        r.read_vertices().view(np.uint32), verts.view(np.uint32))
    np.testing.assert_array_equal(r.read_triangles(), tris)

    w = ArchiveWriter(chunk_len=256, layout="tpu")
    w.write_vertices(verts)
    w.write_triangles(tris)
    assert blob == w.tobytes(), \
        "distributed archive differs from host ArchiveWriter bytes"


@needs8
def test_compress_mesh_device_count_invariance():
    """Archive bytes must not depend on how many devices encoded them."""
    n = 2048
    verts = np.stack([mesh_like_floats(n, seed=s) for s in (7, 8, 9)], axis=1)
    blobs = {
        mesh_codec.compress_mesh(verts, chunk_len=128,
                                 mesh=mesh_codec.make_mesh(k))
        for k in (1, 2, 8)
    }
    assert len(blobs) == 1


@needs8
def test_decode_vertices_sharded_roundtrip():
    """Collective-free distributed decode: container -> scatter -> per-device
    v2 parse+replay, no cross-device communication."""
    from trico_tpu import chunked

    n = 4096 + 37
    vals = mesh_like_floats(n, seed=10).view(np.uint32)
    blob = chunked.encode_chunked(vals, chunk_len=512, layout="tpu")
    mesh = mesh_codec.make_mesh(8)
    out = mesh_codec.decode_vertices_sharded(blob, mesh=mesh)
    np.testing.assert_array_equal(out, vals)

@needs8
def test_compress_mesh_full_streams_roundtrip():
    """Full-mesh distributed pipeline: vertices + triangles + normals +
    colors + uvs -> one v1 archive -> sharded decompress_mesh, bit-exact."""
    n = 1500
    rng = np.random.default_rng(3)
    verts = np.stack([mesh_like_floats(n, seed=s) for s in (1, 2, 3)], axis=1)
    tris = rng.integers(0, n, (2200, 3)).astype(np.uint32)
    normals = np.stack([mesh_like_floats(n, seed=s) for s in (4, 5, 6)], axis=1)
    colors = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    uvs = np.stack([mesh_like_floats(n, seed=s) for s in (7, 8)], axis=1)
    mesh = mesh_codec.make_mesh(8)
    blob = mesh_codec.compress_mesh(
        verts, tris, vertex_normals=normals, vertex_colors=colors,
        uv_per_vertex=uvs, chunk_len=128, mesh=mesh)

    out = mesh_codec.decompress_mesh(blob, mesh=mesh)
    np.testing.assert_array_equal(out["vertices"].view(np.uint32),
                                  verts.astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(out["triangles"], tris)
    np.testing.assert_array_equal(out["vertex_normals"].view(np.uint32),
                                  normals.astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(out["vertex_colors"], colors)
    np.testing.assert_array_equal(out["uv_per_vertex"].view(np.uint32),
                                  uvs.astype(np.float32).view(np.uint32))

    # and the plain host reader agrees stream by stream
    from trico_tpu.archive import ArchiveReader

    r = ArchiveReader(blob)
    np.testing.assert_array_equal(
        r.read_vertices().view(np.uint32),
        verts.astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(r.read_triangles(), tris)
    np.testing.assert_array_equal(
        r.read_vertex_normals().view(np.uint32),
        normals.astype(np.float32).view(np.uint32))
    np.testing.assert_array_equal(r.read_vertex_colors(), colors)
    np.testing.assert_array_equal(
        r.read_uv_per_vertex().view(np.uint32),
        uvs.astype(np.float32).view(np.uint32))


@needs8
def test_compress_mesh_f64_vertices():
    """Distributed f64 vertex encode (shard_map over (hi, lo) word planes):
    bit-exact round-trip and identical bytes to the host ArchiveWriter."""
    from trico_tpu.archive import ArchiveReader, ArchiveWriter

    n = 700  # chunk_len 128 -> 5 full chunks + tail per plane
    verts64 = np.stack(
        [mesh_like_floats(n, seed=s, dtype=np.float64) for s in (11, 12, 13)],
        axis=1)
    mesh = mesh_codec.make_mesh(8)
    blob = mesh_codec.compress_mesh(verts64, chunk_len=128, mesh=mesh)
    r = ArchiveReader(blob)
    np.testing.assert_array_equal(
        r.read_vertices_double().view(np.uint64), verts64.view(np.uint64))

    w = ArchiveWriter(chunk_len=128, layout="tpu")
    w.write_vertices_double(verts64)
    assert blob == w.tobytes(), \
        "distributed f64 archive differs from host ArchiveWriter bytes"


@needs8
def test_compress_mesh_empty_stream():
    """ADVICE r2 medium: a 0-element vertex stream produced an empty chunked
    container that decode_vertices_sharded crashed on (n_full = -1)."""
    mesh = mesh_codec.make_mesh(8)
    blob = mesh_codec.compress_mesh(np.zeros((0, 3), np.float32), mesh=mesh)
    out = mesh_codec.decompress_mesh(blob, mesh=mesh)
    assert out["vertices"].shape == (0, 3)


@needs8
def test_compress_mesh_f64_device_count_invariance():
    n = 512
    verts64 = np.stack(
        [mesh_like_floats(n, seed=s, dtype=np.float64) for s in (21, 22, 23)],
        axis=1)
    blobs = {
        mesh_codec.compress_mesh(verts64, chunk_len=64,
                                 mesh=mesh_codec.make_mesh(k))
        for k in (1, 2, 8)
    }
    assert len(blobs) == 1


@needs8
def test_compress_mesh_fast_profile_matches_archive_writer():
    """optimize="fast" (the CLI --fast profile) on the distributed path:
    bit-identical to ArchiveWriter(optimize="fast"), round-trips, and
    differs from the full-search default on data where the search wins."""
    from trico_tpu.archive import ArchiveReader, ArchiveWriter

    n = 3000
    rng = np.random.default_rng(11)
    # quantized CAD-like coords: the big-table candidate wins chunks here
    verts = np.stack([
        np.round(mesh_like_floats(n, seed=s) * 64) / 64 for s in (4, 5, 6)
    ], axis=1).astype(np.float32)
    mesh = mesh_codec.make_mesh(8)
    blob_fast = mesh_codec.compress_mesh(verts, chunk_len=256, mesh=mesh,
                                         optimize="fast")
    w = ArchiveWriter(chunk_len=256, layout="tpu", optimize="fast")
    w.write_vertices(verts)
    assert blob_fast == w.tobytes()
    r = ArchiveReader(blob_fast)
    np.testing.assert_array_equal(
        r.read_vertices().view(np.uint32), verts.view(np.uint32))
    blob_full = mesh_codec.compress_mesh(verts, chunk_len=256, mesh=mesh)
    # strict: the full search must genuinely win on quantized data, or the
    # profile plumbing silently collapsed to one path (21,092 vs 21,139 B)
    assert len(blob_full) < len(blob_fast)

    # f64 leg: fast profile restricts to F64_TPU_CANDIDATES_FAST on the
    # sharded path too, bit-identical to the host writer
    verts64 = verts.astype(np.float64)
    blob64 = mesh_codec.compress_mesh(verts64, chunk_len=256, mesh=mesh,
                                      optimize="fast")
    w64 = ArchiveWriter(chunk_len=256, layout="tpu", optimize="fast")
    w64.write_vertices_double(verts64)
    assert blob64 == w64.tobytes()
    r64 = ArchiveReader(blob64)
    np.testing.assert_array_equal(
        r64.read_vertices_double().view(np.uint64), verts64.view(np.uint64))
