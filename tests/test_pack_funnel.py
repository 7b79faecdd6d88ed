"""Word-funnel pack (pack_funnel.py) vs the byte-slot network."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from trico_tpu.codec import fp_jax, pack_funnel

LENS_TAB = np.array([0, 1, 2, 3, 4, 1, 2, 3])


def _rand_bcode_res(rng, C, L, all_code=None):
    p = [0.35, 0.1, 0.15, 0.15, 0.1, 0.05, 0.05, 0.05]
    bc = rng.choice(8, size=(C, L), p=p).astype(np.uint8)
    if all_code is not None:
        bc[:] = all_code
    res = rng.integers(0, 2**32, size=(C, L), dtype=np.uint32)
    lens = LENS_TAB[bc]
    mask = np.where(lens > 0,
                    (np.uint64(1) << (8 * lens).astype(np.uint64)) - 1,
                    0).astype(np.uint64)
    res = (res.astype(np.uint64) & mask).astype(np.uint32)
    return bc, res, lens.astype(np.int32)


@pytest.mark.parametrize("L", [64, 512, 1024])
@pytest.mark.parametrize("all_code", [None, 0, 4])
def test_funnel_equals_slot_network(L, all_code):
    rng = np.random.default_rng(11)
    bc, res, lens = _rand_bcode_res(rng, 6, L, all_code)
    old_env = os.environ.get("TRICO_TPU_PACK")
    try:
        os.environ["TRICO_TPU_PACK"] = "slots"
        jax.clear_caches()
        p_old, s_old = jax.jit(functools.partial(
            fp_jax._pack_f32_chunks_v2_impl, e1=4, e2=6))(
            jnp.asarray(bc), jnp.asarray(res))
        p_old, s_old = np.asarray(p_old), np.asarray(s_old)
    finally:
        os.environ.pop("TRICO_TPU_PACK", None)
        if old_env is not None:
            os.environ["TRICO_TPU_PACK"] = old_env
    jax.clear_caches()
    p_new, s_new = jax.jit(functools.partial(
        fp_jax._pack_f32_chunks_v2_impl, e1=4, e2=6))(
        jnp.asarray(bc), jnp.asarray(res))
    np.testing.assert_array_equal(np.asarray(s_new), s_old)
    np.testing.assert_array_equal(np.asarray(p_new), p_old)


def test_adaptive_candidates_shared_e2_matches_generic():
    """The shared-e2 fast path picks the same chunks as per-candidate encode."""
    rng = np.random.default_rng(19)
    C, L = 8, 256
    vals = (np.sin(np.linspace(0, 60, C * L)) * 9
            + rng.normal(0, 1e-3, C * L).cumsum()).astype(np.float32)
    v = jnp.asarray(vals.view(np.uint32).reshape(C, L))
    pay, sizes = fp_jax.encode_f32_chunks_v2_adaptive(v)
    # every chunk's size equals the min over single-candidate encodes
    singles = [
        np.asarray(fp_jax.encode_f32_chunks_v2(v, e1, e2)[1])
        for (e1, e2) in fp_jax.F32_TPU_CANDIDATES
    ]
    np.testing.assert_array_equal(np.asarray(sizes),
                                  np.min(np.stack(singles), axis=0))
    # and the chosen payloads decode exactly
    out = fp_jax.decode_f32_chunks_v2(pay, L, *fp_jax.F32_TPU_CANDIDATES[0])
    # decode_f32_chunks_v2 reads exponents only via the replay args; decode
    # each hash_info group as chunked.decode_chunked would
    hinfos = np.asarray(pay)[:, 0]
    vals_out = np.zeros((C, L), np.uint32)
    for hi in np.unique(hinfos):
        idx = np.nonzero(hinfos == hi)[0]
        e1, e2 = (int(hi) >> 4) << 1, (int(hi) & 15) << 1
        dec = fp_jax.decode_f32_chunks_v2(jnp.asarray(np.asarray(pay)[idx]), L, e1, e2)
        vals_out[idx] = np.asarray(dec)
    np.testing.assert_array_equal(vals_out, np.asarray(v))
