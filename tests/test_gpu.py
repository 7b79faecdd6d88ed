"""Card-only tests: the replay kernel as Triton compiles it for the GPU, and
the device paths that call it. They skip without a CUDA GPU; on the card,
``python chip_smoke.py`` runs them (phase 7). The interpret-mode twins of
these checks run everywhere (tests/test_replay_kernel.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trico_tpu.codec import fp_jax, fp_ref, replay_triton

from conftest import mesh_like_floats

pytestmark = pytest.mark.gpu


def _chunks(C, L, seed=0):
    return mesh_like_floats(C * L, seed=seed).view(np.uint32).reshape(C, L)


def test_route_on_card_is_triton():
    assert fp_jax.kernel_route() == "triton"


@pytest.mark.parametrize("C", [1, 300])
@pytest.mark.parametrize("e1,e2", [(0, 6), (4, 6), (4, 10)])
def test_compiled_replay_matches_scan(e1, e2, C):
    L = 4096
    chunks = _chunks(C, L, seed=C + e2)
    bc, res = fp_jax.predict_f32_chunks(jnp.asarray(chunks), e1, e2)
    got = replay_triton.replay(bc, res, e1, e2)
    want = jax.jit(fp_jax._replay_scan, static_argnums=(2, 3))(bc, res, e1, e2)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    np.testing.assert_array_equal(np.asarray(got), chunks)


def test_device_v2_roundtrip_matches_oracle():
    C, L = 700, 1024
    chunks = _chunks(C, L, seed=3)
    pay, sizes = fp_jax.encode_f32_chunks_v2_adaptive(jnp.asarray(chunks))
    pay, sizes = np.asarray(pay), np.asarray(sizes)
    for c in (0, C // 2, C - 1):
        e1, e2 = (int(pay[c, 0]) >> 4) << 1, (int(pay[c, 0]) & 15) << 1
        want = fp_jax.relayout_f32_v1_to_v2(
            np.frombuffer(fp_ref.compress(chunks[c], e1, e2), np.uint8))
        assert pay[c, : sizes[c]].tobytes() == want.tobytes()
    for hi in np.unique(pay[:, 0]):
        idx = np.nonzero(pay[:, 0] == hi)[0]
        e1, e2 = (int(hi) >> 4) << 1, (int(hi) & 15) << 1
        dec = fp_jax.decode_f32_chunks_v2(jnp.asarray(pay[idx]), L, e1, e2)
        np.testing.assert_array_equal(np.asarray(dec), chunks[idx])


def test_sharded_decode_runs_kernel_under_shard_map():
    from trico_tpu.parallel import mesh_codec

    verts = mesh_like_floats(3 * 200_000, seed=5).reshape(-1, 3)
    mesh = mesh_codec.make_mesh(1)
    blob = mesh_codec.compress_mesh(verts, mesh=mesh, optimize="fast")
    stats = {}
    out = mesh_codec.decompress_mesh(blob, mesh, route_stats=stats)
    assert stats["sharded_fp"] == 3
    np.testing.assert_array_equal(out["vertices"].view(np.uint32),
                                  verts.view(np.uint32))
