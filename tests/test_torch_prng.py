"""The port's threefry PRNG (``repro_torch.prng``) against ``jax.random``
from the same seeds, under both values of ``jax_threefry_partitionable``
(the port takes the layout as its ``partitionable`` argument): keys,
splits, bits (odd, even and the per-lane decode draw's shapes, a slice of
a draw by its counters, keys vmapped) and uniforms bit for bit; Gumbel
noise within 2 ulp of max(|g|, 1) (the noise's absolute scale where it
meets the logits: torch's and XLA's ``log`` differ by an ulp, and
-log(-log u) near 0 turns that into many ulps of a tiny value); the
categorical draw's indices equal; ``split_lane_keys`` with a partial
``active`` mask equal."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jax_get_config  # noqa: E402
from repro.core import diffusion as jax_d  # noqa: E402
from repro_torch import prng  # noqa: E402
from repro_torch.core import diffusion as D  # noqa: E402

V_REDUCED = jax_get_config("qwen2-0.5b").reduced().vocab_size
SEEDS = (0, 7, 123456789)
SHAPES = [(1,), (7,), (3, 5, 1000), (2, 32, V_REDUCED)]
GUMBEL_ULP = 2


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def partitionable(request):
    """Set ``jax_threefry_partitionable`` for one test, then restore it."""
    before = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", before)


def _key(jkey):
    return torch.as_tensor(np.asarray(jkey).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS + (2 ** 32 + 5, -3))
def test_key_is_prngkey(seed):
    np.testing.assert_array_equal(prng.key(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3])
@pytest.mark.parametrize("seed", SEEDS)
def test_split_matches_jax(partitionable, seed, num):
    want = jax.random.split(jax.random.PRNGKey(seed), num)
    got = prng.split(prng.key(seed), num, partitionable=partitionable)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_bits_and_uniform_match_jax(partitionable, seed, shape):
    k = jax.random.PRNGKey(seed)
    got = prng.bits(prng.key(seed), shape, partitionable=partitionable)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.bits(k, shape)))
    got = prng.uniform(prng.key(seed), shape, partitionable=partitionable)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax.random.uniform(k, shape)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_gumbel_within_two_ulp(partitionable, shape):
    for seed in SEEDS:
        want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(seed),
                                            shape))
        got = prng.gumbel(prng.key(seed), shape,
                          partitionable=partitionable).numpy()
        ulp = np.spacing(np.maximum(np.abs(want), 1).astype(np.float32))
        assert float((np.abs(got - want) / ulp).max()) <= GUMBEL_ULP


def test_vmapped_bits_and_slices(partitionable):
    """Keys with a batch dimension draw as ``jax.vmap`` over them; a slice
    of a draw by its flat counters equals the whole draw there."""
    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    want = jax.vmap(lambda k: jax.random.bits(k, (5, 9)))(keys)
    got = prng.bits(_key(keys), (5, 9), partitionable=partitionable)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    whole = prng.bits(prng.key(3), (3, 11, 13), partitionable=partitionable)
    for dt in (torch.int32, torch.int64):
        index = (torch.arange(2 * 13, 6 * 13).reshape(4, 13)
                 + 11 * 13).to(dt)
        part = prng.bits(prng.key(3), (3, 11, 13),
                         partitionable=partitionable, index=index)
        assert torch.equal(part, whole[1, 2:6])


@pytest.mark.parametrize("seed", SEEDS)
def test_categorical_matches_jax(partitionable, seed):
    logits = np.random.default_rng(seed).normal(
        0, 3, (4, 6, V_REDUCED)).astype(np.float32)
    k = jax.random.PRNGKey(seed)
    want = jax.random.categorical(k, jnp.asarray(logits))
    got = prng.categorical(prng.key(seed), torch.as_tensor(logits),
                           partitionable=partitionable)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    keys = jax.random.split(k, 4)
    want = jax.vmap(jax.random.categorical)(keys, jnp.asarray(logits))
    got = prng.categorical(_key(keys), torch.as_tensor(logits),
                           partitionable=partitionable)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_split_lane_keys_with_a_partial_active_mask():
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    active = np.array([True, False, True, False, True])
    want = jax_d.split_lane_keys(keys, jnp.asarray(active))
    got = D.split_lane_keys(_key(keys), torch.as_tensor(active))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # inactive lanes keep their key
    np.testing.assert_array_equal(got[0].numpy()[~active],
                                  np.asarray(keys)[~active])
