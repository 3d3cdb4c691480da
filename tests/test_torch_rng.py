"""The port's threefry keys and uniforms equal ``jax.random`` bit for bit,
under both ``jax_threefry_partitionable`` layouts.

Tolerance: 0 everywhere (exact equality of u32 words and f32 values)."""

import gossip_sim_tpu.engine  # noqa: F401  (64-bit types, as the engine runs)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gossip_sim_tpu_torch import rng


@pytest.fixture(params=[True, False], ids=["partitionable", "original"])
def layout(request):
    """Pin both packages to one threefry layout; restore afterwards."""
    old = jax.config.jax_threefry_partitionable
    old_port = rng.partitionable()
    jax.config.update("jax_threefry_partitionable", request.param)
    rng.set_partitionable(request.param)
    yield request.param
    jax.config.update("jax_threefry_partitionable", old)
    rng.set_partitionable(old_port)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.numpy()


@pytest.mark.parametrize("seed", [0, 42, 2**40 + 17])
def test_prng_key(layout, seed):
    assert np.array_equal(np.asarray(jax.random.PRNGKey(seed)).astype(np.int64),
                          _np(rng.prng_key(seed)))


def test_fold_in_batched(layout):
    key = jax.random.PRNGKey(7)
    data = np.array([0, 1, 5, 0x696E6974, 2**32 - 1], dtype=np.uint32)
    want = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        key, jnp.asarray(data))
    got = rng.fold_in(rng.prng_key(7)[None, :].expand(len(data), 2),
                      torch.as_tensor(data.astype(np.int64)))
    assert np.array_equal(np.asarray(want).astype(np.int64), _np(got))


@pytest.mark.parametrize("num", [1, 2, 7, 10])
def test_split(layout, num):
    key = jax.random.fold_in(jax.random.PRNGKey(3), 11)
    got = rng.split(rng.fold_in(rng.prng_key(3), 11), num)
    assert np.array_equal(np.asarray(jax.random.split(key, num)).astype(
        np.int64), _np(got))


@pytest.mark.parametrize("shape", [(1,), (6,), (7,), (33, 2), (4, 3, 2)])
def test_uniform(layout, shape):
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(9), jnp.arange(3, dtype=jnp.int32))
    want = jax.vmap(lambda k: jax.random.uniform(k, shape,
                                                 dtype=jnp.float32))(keys)
    tkeys = rng.fold_in(rng.prng_key(9)[None, :].expand(3, 2),
                        torch.arange(3))
    got = rng.uniform(tkeys, shape)
    assert got.dtype == torch.float32
    assert np.array_equal(np.asarray(want), _np(got))


def test_explicit_layout_argument_overrides_the_default(layout):
    key = rng.prng_key(5)
    other = not layout
    jax.config.update("jax_threefry_partitionable", other)
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(5), (9,),
                                         dtype=jnp.float32))
    assert np.array_equal(want, _np(rng.uniform(key, (9,),
                                                partitionable=other)))
