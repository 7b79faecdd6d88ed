import os

# Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
# exercised without accelerator hardware. Set TRICO_TEST_PLATFORM=gpu to keep
# the process's own backend instead (chip_smoke.py does, to run the
# `gpu`-marked tests on the card).
ON_CARD = os.environ.get("TRICO_TEST_PLATFORM") == "gpu"
if not ON_CARD:
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault("TRICO_TPU_SCAN_UNROLL", "1")  # fast compiles on CPU
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import sys
from pathlib import Path

import jax
import numpy as np
import pytest

if not ON_CARD:
    jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, str(Path(__file__).resolve().parent))
REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from trico_tpu.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

BUNNY = REPO / "tests" / "data" / "StanfordBunny.stl"


@pytest.fixture(autouse=True)
def _gpu_marker_needs_card(request):
    """Tests marked ``gpu`` run a kernel compiled for the card (no interpret
    mode exists for it); they skip unless JAX's default device is a GPU. The
    check runs here, per test, never at import time."""
    if request.node.get_closest_marker("gpu") is None:
        return
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a CUDA GPU; run `python chip_smoke.py` on the card")


@pytest.fixture(scope="session")
def bunny_path():
    if not BUNNY.exists():
        pytest.skip("StanfordBunny.stl fixture not available")
    return BUNNY


@pytest.fixture(scope="session")
def bunny_vertices(bunny_path):
    """Deduplicated float32 vertex array (N, 3) of the bunny fixture."""
    from trico_tpu.io.stl import read_stl

    verts, tris = read_stl(bunny_path)
    return verts


@pytest.fixture(scope="session")
def bunny_triangles(bunny_path):
    """Deduplicated uint32 triangle index array (M, 3) of the bunny fixture."""
    from trico_tpu.io.stl import read_stl

    verts, tris = read_stl(bunny_path)
    return tris


def rng(seed=0):
    return np.random.default_rng(seed)


def mesh_like_floats(n, seed=0, dtype=np.float32):
    """Synthetic smooth coordinate stream (compresses like mesh data)."""
    r = np.random.default_rng(seed)
    t = np.linspace(0, 20 * np.pi, n, dtype=np.float64)
    vals = np.sin(t) * 10 + np.cumsum(r.normal(0, 1e-3, n))
    return vals.astype(dtype)
