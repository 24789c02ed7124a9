"""Checks that need an NVIDIA GPU.  They skip on other platforms; run them
on a card with

    JAX_PLATFORMS=cuda python -m pytest tests -m gpu
"""

import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        pytest.skip(f"needs a GPU; the JAX platform is {dev.platform!r}")
    return dev


@pytest.mark.parametrize("seed,k,light", [(404, 21, False), (707, 17, True)])
def test_oracle_equivalence_on_card(gpu, tmp_path, seed, k, light):
    """Build + classify on the card match the brute-force oracle."""
    from .test_property import test_random_equivalence

    test_random_equivalence(tmp_path, seed, k, light)


def test_device_memory_limit_on_card(gpu):
    """The card reports its memory, so auto-cycling has a budget."""
    from jn_cuclark_tpu.utils import memory

    limit = memory.device_memory_limit(gpu)
    assert limit > (1 << 30)
    cycles, budget = memory.auto_db_cycles(1 << 30, 1 << 23, device=gpu)
    assert cycles == 1 and budget > (1 << 30)
