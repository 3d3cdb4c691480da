"""The port's threefry keys and uniforms equal ``jax.random`` bit for bit,
under both ``jax_threefry_partitionable`` layouts; so do the word maps of
``csrc/threefry.cuh`` (their Python mirrors), with which ``rotate`` draws
one word at a time.

Tolerance: 0 everywhere (exact equality of u32 words and f32 values)."""

import importlib

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


# ---- the threefry kernel module's plain version ---------------------------

tf = importlib.import_module("gossip_sim_tpu_torch.kernels.threefry")


def _jax_keys(shape):
    """A [*shape, 2] batch of distinct JAX keys and the port's copy."""
    n = int(np.prod(shape))
    keys = jax.vmap(jax.random.fold_in, in_axes=(None, 0))(
        jax.random.PRNGKey(21), jnp.arange(n, dtype=jnp.uint32))
    keys = np.asarray(keys).astype(np.int64).reshape(*shape, 2)
    return keys, torch.as_tensor(keys)


def _jax_batched(fn, keys_np):
    """Apply a one-key JAX function over every key of a [..., 2] batch."""
    flat = jnp.asarray(keys_np.reshape(-1, 2).astype(np.uint32))
    out = np.asarray(jax.vmap(fn)(flat))
    return out.reshape(*keys_np.shape[:-1], *out.shape[1:])


@pytest.mark.parametrize("size", [1, 8, 33])
def test_threefry_plain_draws_equal_jax(layout, size):
    """split, bits and uniform of odd and even sizes under an [O, T] key
    batch, and under a non-contiguous slice of it (as subs[:, 2:2+T])."""
    keys_np, keys = _jax_keys((3, 6))
    cases = {"o_t": (keys_np, keys),
             "slice": (keys_np[:, 2:5], keys[:, 2:5])}
    assert not keys[:, 2:5].is_contiguous()
    for what, (knp, kt) in cases.items():
        want = {
            "split": _jax_batched(lambda k: jax.random.split(k, size), knp),
            "bits": _jax_batched(
                lambda k: jax.random.bits(k, (size,), jnp.uint32), knp),
            "uniform": _jax_batched(
                lambda k: jax.random.uniform(k, (size,), jnp.float32), knp),
        }
        for op, w in want.items():
            got = tf.threefry_plain(kt, op, size, layout).numpy()
            if op != "uniform":
                w = w.astype(np.int64)
            assert got.dtype == w.dtype and np.array_equal(w, got), (what, op)


def test_threefry_plain_fold_in_equals_jax(layout):
    """fold_in with a scalar counter and a per-key counter (as init_state
    folds each origin into its copy of the key)."""
    keys_np, keys = _jax_keys((5,))
    data = np.array([0, 3, 0x696E6974, 2**32 - 1, 12], np.uint32)
    want = jax.vmap(jax.random.fold_in)(jnp.asarray(keys_np.astype(np.uint32)),
                                        jnp.asarray(data))
    got = tf.threefry_plain(keys, "fold_in", torch.as_tensor(
        data.astype(np.int64)), layout)
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    want = jax.vmap(jax.random.fold_in, in_axes=(0, None))(
        jnp.asarray(keys_np.astype(np.uint32)), 77)
    got = tf.threefry_plain(keys, "fold_in", 77, layout)
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


def test_rng_goes_through_the_kernel_module(layout, monkeypatch):
    """Every public draw of ``rng`` is one call of ``kernels.threefry``,
    looked up at call time (so a recorder sees each call)."""
    from gossip_sim_tpu_torch import kernels
    seen = []
    real = kernels.threefry

    def recorder(keys, op, arg, *rest):
        seen.append(op)
        return real(keys, op, arg, *rest)

    monkeypatch.setattr(kernels, "threefry", recorder)
    key = rng.prng_key(4)
    k2 = rng.fold_in(key, 1)
    subs = rng.split(k2[None, :], 3)
    rng.uniform(subs[:, 1:3], (4, 2))
    rng.random_bits(subs[:, 0], 5)
    assert seen == ["fold_in", "split", "uniform", "bits"]


# ---- the word maps of csrc/threefry.cuh (rotate draws one word at a time) --

@pytest.mark.parametrize("n", [1, 2, 7, 40, 41, 1001])
def test_word_at_mirrors_every_flat_index(layout, n):
    """``word_at`` (the mirror of ``tf_word``) gives word f of an n-word
    draw for every f: the words of ``rng.random_bits`` and, mapped to
    floats, ``rng.uniform``; odd n takes the original layout's zero pad."""
    _, keys = _jax_keys((3, 2))
    f = torch.arange(n)
    got = tf.word_at(keys[..., None, :], f, n, layout)            # [3, 2, n]
    assert torch.equal(got, rng.random_bits(keys, n))
    assert torch.equal(tf.bits_to_uniform(got), rng.uniform(keys, (n,)))
    # as rotate draws them: word node of an N-word draw, and words 2 node
    # and 2 node + 1 of a 2N-word draw
    u2 = rng.uniform(keys, (n, 2))
    for c in (0, 1):
        assert torch.equal(tf.bits_to_uniform(
            tf.word_at(keys[..., None, :], 2 * f + c, 2 * n, layout)),
            u2[..., c])


@pytest.mark.parametrize("tries", [1, 8, 32])
def test_split_word_mirrors_every_key(layout, tries):
    """``split_word`` (the mirror of ``tf_split_word``) gives both words of
    every key of ``split(key, T + 2)``, and the round's sub keys of the
    reference engine: ``jax.random.split(fold_in(key, it), T + 2)``."""
    keys_np, keys = _jax_keys((4,))
    m = tries + 2
    want = rng.split(keys, m)                                     # [4, m, 2]
    i = torch.arange(m)
    for w in (0, 1):
        assert torch.equal(tf.split_word(keys[:, None, :], i, w, m, layout),
                           want[..., w])
    kr = jax.vmap(jax.random.fold_in, in_axes=(0, None))(
        jnp.asarray(keys_np.astype(np.uint32)), 2**31 + 9)
    subs = np.asarray(jax.vmap(lambda k: jax.random.split(k, m))(kr))
    kr_t = tf.threefry_plain(keys, "fold_in", 2**31 + 9)
    for w in (0, 1):
        got = tf.split_word(kr_t[:, None, :], i, w, m, layout)
        assert np.array_equal(got.numpy(), subs[..., w].astype(np.int64))
