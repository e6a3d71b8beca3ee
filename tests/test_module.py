"""The in-repo module layer (reptext/nn/module.py).

The parameter trees of every model are pinned by a recorded fixture: paths,
shapes and dtypes must not move, because weight conversion, checkpoints,
LoRA, fp8 storage and the sharding rules address parameters by path.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from reptext.nn import module as nn
from tests.record_param_trees import FIXTURE, model_cases, param_trees

_CASES = sorted(json.load(open(FIXTURE)))


@pytest.fixture(scope="module")
def trees():
    return param_trees()


@pytest.mark.parametrize("name", _CASES)
def test_param_tree_matches_fixture(trees, name):
    with open(FIXTURE) as f:
        expected = json.load(f)[name]
    assert trees[name] == expected


def test_fixture_covers_every_model_case():
    assert sorted(model_cases()) == _CASES


class _MLP(nn.Module):
    hidden: int

    @nn.compact
    def __call__(self, x):
        x = nn.relu(nn.Dense(self.hidden)(x))
        return nn.Dense(2, name="head")(x)


def test_dense_and_auto_names_apply_is_pure_math():
    x = jnp.arange(6.0).reshape(2, 3)
    params = _MLP(4).init(jax.random.PRNGKey(0), x)
    assert set(params["params"]) == {"Dense_0", "head"}
    p = params["params"]
    want = np.maximum(x @ p["Dense_0"]["kernel"] + p["Dense_0"]["bias"], 0)
    want = want @ p["head"]["kernel"] + p["head"]["bias"]
    np.testing.assert_allclose(_MLP(4).apply(params, x), want, rtol=1e-6)


def test_init_under_jit_matches_eager():
    x = jnp.ones((1, 3))
    eager = _MLP(4).init(jax.random.PRNGKey(3), x)
    jitted = jax.jit(_MLP(4).init)(jax.random.PRNGKey(3), x)
    jax.tree_util.tree_map(np.testing.assert_array_equal, eager, jitted)


class _Layer(nn.Module):
    @nn.compact
    def __call__(self, carry, x):
        y = nn.Dense(carry.shape[-1], name="lin")(carry) + x
        return y, jnp.sum(y)


def _stacked(remat):
    layer = nn.remat(_Layer) if remat else _Layer

    class Stack(nn.Module):
        @nn.compact
        def __call__(self, c, xs):
            return nn.scan(layer, length=3, in_axes=0)(name="layers")(c, xs)

    return Stack()


@pytest.mark.parametrize("remat", [False, True])
def test_scan_stacks_params_and_matches_a_loop(remat):
    c = jnp.ones((2, 4))
    xs = jnp.arange(3.0)[:, None, None] * jnp.ones((3, 2, 4))
    model = _stacked(remat)
    params = model.init(jax.random.PRNGKey(0), c, xs)
    lin = params["params"]["layers"]["lin"]
    assert lin["kernel"].shape == (3, 4, 4)
    assert not np.allclose(lin["kernel"][0], lin["kernel"][1])
    (out, ys) = model.apply(params, c, xs)
    want = c
    for i in range(3):
        want = want @ lin["kernel"][i] + lin["bias"][i] + xs[i]
    np.testing.assert_allclose(out, want, rtol=1e-5)
    assert ys.shape == (3,)
    g = jax.grad(lambda p: model.apply(p, c, xs)[0].sum())(params)
    assert g["params"]["layers"]["lin"]["kernel"].shape == (3, 4, 4)


def test_scan_init_traces_layers_unbatched():
    """A layer op with no batching rule (like cuDNN attention with sequence
    lengths) must survive init of a scanned stack."""

    @jax.custom_batching.custom_vmap
    def unbatchable(x):
        return x

    @unbatchable.def_vmap
    def _refuse(axis_size, in_batched, x):
        raise AssertionError("init batched a layer's ops")

    class Layer(nn.Module):
        @nn.compact
        def __call__(self, c, x):
            return unbatchable(nn.Dense(4, name="lin")(c) + x), None

    class Stack(nn.Module):
        @nn.compact
        def __call__(self, c, xs):
            return nn.scan(Layer, length=3)(name="layers")(c, xs)

    c, xs = jnp.ones((2, 4)), jnp.ones((3, 2, 4))
    params = Stack().init(jax.random.PRNGKey(1), c, xs)
    kernel = params["params"]["layers"]["lin"]["kernel"]
    assert kernel.shape == (3, 4, 4)
    assert not np.allclose(kernel[0], kernel[1])


def test_map_variables_transforms_params_at_apply_only():
    class Scaled(nn.Module):
        @nn.compact
        def __call__(self, x):
            inner = nn.map_variables(
                _Dense1, "params",
                trans_in_fn=lambda p: jax.tree_util.tree_map(lambda a: 2 * a, p))
            return inner(name="d")(x)

    x = jnp.ones((1, 3))
    params = Scaled().init(jax.random.PRNGKey(0), x)
    k = params["params"]["d"]["lin"]["kernel"]
    np.testing.assert_allclose(Scaled().apply(params, x), x @ (2 * k), rtol=1e-6)


class _Dense1(nn.Module):
    @nn.compact
    def __call__(self, x):
        return nn.Dense(2, use_bias=False, name="lin")(x)


def test_norms_match_numpy():
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 4, 4, 8))
    gn = nn.GroupNorm(num_groups=2, epsilon=1e-6)
    p = gn.init(jax.random.PRNGKey(0), x)
    xg = np.asarray(x).reshape(2, 4, 4, 2, 4)
    mu = xg.mean(axis=(1, 2, 4), keepdims=True)
    var = xg.var(axis=(1, 2, 4), keepdims=True)
    want = ((xg - mu) / np.sqrt(var + 1e-6)).reshape(x.shape)
    np.testing.assert_allclose(gn.apply(p, x), want, atol=1e-5)
    ln = nn.LayerNorm(epsilon=1e-5)
    p = ln.init(jax.random.PRNGKey(0), x)
    xn = np.asarray(x)
    want = (xn - xn.mean(-1, keepdims=True)) / np.sqrt(xn.var(-1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(ln.apply(p, x), want, atol=1e-5)


def test_conv_matches_direct_sum():
    x = jax.random.normal(jax.random.PRNGKey(2), (1, 5, 5, 2))
    conv = nn.Conv(3, (3, 3), padding=1)
    p = conv.init(jax.random.PRNGKey(0), x)
    k = np.asarray(p["params"]["kernel"])
    xp = np.pad(np.asarray(x), ((0, 0), (1, 1), (1, 1), (0, 0)))
    want = np.zeros((1, 5, 5, 3), np.float32)
    for i in range(5):
        for j in range(5):
            want[0, i, j] = np.einsum("hwc,hwco->o", xp[0, i:i + 3, j:j + 3], k)
    np.testing.assert_allclose(conv.apply(p, x), want + np.asarray(p["params"]["bias"]),
                               atol=1e-5)


def test_clone_and_unbound_call_error():
    m = _MLP(4)
    assert m.clone(hidden=8).hidden == 8 and m.hidden == 4
    with pytest.raises(ValueError, match="unbound"):
        m(jnp.ones((1, 3)))
