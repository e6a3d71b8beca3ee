"""A small module layer over plain JAX: parameters as nested dicts.

The models here are written in the style of ``flax.linen``: a module is a
dataclass whose ``@compact`` method creates its parameters and submodules as
it runs. This module implements exactly the subset the repository uses, so
the package needs nothing beyond JAX:

- ``Module`` with ``@compact`` methods, ``setup``, ``param``, ``clone``,
  ``init`` and ``apply`` over the ``{"params": ...}`` collection (plus
  ``capture_intermediates`` for io/verify_activations.py);
- layers: ``Dense``, ``Conv``, ``GroupNorm``, ``LayerNorm``, ``Embed``;
- transforms: ``scan`` over stacked layer parameters, ``remat`` and
  ``map_variables``.

Parameter paths follow the flax conventions (explicit ``name=`` or
``ClassName_<n>`` per parent, ``kernel``/``bias``/``scale``/``embedding``
leaf names, a scanned layer's parameters stacked on a leading axis), so
converted checkpoints, LoRA merging, fp8 storage and the sharding rules all
address the same trees. ``tests/fixtures/param_trees.json`` pins them.
"""

from __future__ import annotations

import copy
import dataclasses
import functools
import inspect
import threading
import zlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
from jax import lax

initializers = jax.nn.initializers
silu = jax.nn.silu
gelu = jax.nn.gelu
relu = jax.nn.relu
sigmoid = jax.nn.sigmoid
softmax = jax.nn.softmax

Dtype = Any
Array = jax.Array


class _Broadcast:
    """``scan`` in_axes marker: the argument is passed whole to every layer."""

    def __repr__(self):
        return "broadcast"


broadcast = _Broadcast()

_STATE = threading.local()


def _stack():
    if not hasattr(_STATE, "stack"):
        _STATE.stack = []
    return _STATE.stack


def _fold(key: Array, name: str) -> Array:
    return jax.random.fold_in(key, zlib.crc32(name.encode()) & 0x7FFFFFFF)


class _Scope:
    """Variables of one module: its params subtree and, while capturing,
    its intermediates subtree. ``init`` scopes create missing params and
    record how (``records``: path, initializer, arguments), so the values can
    be made again from the rng alone."""

    def __init__(self, params: Dict[str, Any], rng: Optional[Array],
                 initializing: bool, intermediates: Optional[Dict] = None,
                 records: Optional[list] = None, path: Tuple[str, ...] = ()):
        self.params = params
        self.rng = rng
        self.initializing = initializing
        self.intermediates = intermediates
        self.records = records
        self.path = path

    def child(self, name: str) -> "_Scope":
        if self.initializing:
            sub = self.params.setdefault(name, {})
        else:
            sub = self.params.get(name, {})
        inter = None
        if self.intermediates is not None:
            inter = self.intermediates.setdefault(name, {})
        rng = None if self.rng is None else _fold(self.rng, name)
        return _Scope(sub, rng, self.initializing, inter, self.records,
                      self.path + (name,))


def _materialize(records: list, rng: Array) -> Dict[str, Any]:
    """Parameter values from ``init``'s records: each is its initializer
    applied to the rng folded along its path, exactly as during init."""
    out: Dict[str, Any] = {}
    for kind, path, *rest in records:
        key = rng
        for name in path:
            key = _fold(key, name)
        node = out
        for name in path[:-1]:
            node = node.setdefault(name, {})
        if kind == "param":
            init_fn, init_args = rest
            node.setdefault(path[-1], init_fn(key, *init_args))
        else:                                    # a scanned stack
            length, inner = rest
            keys = jax.random.split(_fold(key, "scan"), length)
            stacked = jax.vmap(lambda k: _materialize(inner, k))(keys)
            node.setdefault(path[-1], {}).update(stacked)
    return out


class _Detached:
    """Construct modules that belong to no parent (transform bodies)."""

    def __enter__(self):
        _stack().append(None)

    def __exit__(self, *exc):
        _stack().pop()


def compact(fn: Callable) -> Callable:
    """Mark a method that creates parameters and submodules as it runs (every
    public method may; the marker documents which ones do)."""
    return fn


def _wrap_method(fn: Callable) -> Callable:
    @functools.wraps(fn)
    def wrapped(self, *args, **kwargs):
        if self._scope is None:
            raise ValueError(
                f"{type(self).__name__}.{fn.__name__} called on an unbound "
                "module; use .init(rng, ...) or .apply(variables, ...)")
        stack = _stack()
        outermost = not any(m is self for m in stack)
        stack.append(self)
        try:
            self._ensure_setup()
            if outermost:
                self._counters = {}
            out = fn(self, *args, **kwargs)
        finally:
            stack.pop()
        if fn.__name__ == "__call__" and self._scope.intermediates is not None:
            calls = self._scope.intermediates.get("__call__", ())
            self._scope.intermediates["__call__"] = calls + (out,)
        return out

    return wrapped


class Module:
    """Base class. Subclasses are dataclasses of their hyper-parameters."""

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        fields = vars(cls).get("__annotations__", {})
        for attr, value in list(vars(cls).items()):
            if (inspect.isfunction(value) and attr not in fields
                    and (attr == "__call__" or not attr.startswith("_"))
                    and attr not in ("setup", "init", "apply", "clone",
                                     "param")):
                setattr(cls, attr, _wrap_method(value))
        if not getattr(cls, "_no_dataclass", False):
            dataclasses.dataclass(cls, eq=False, repr=False)
            field_init = cls.__init__

            def __init__(self, *args, name: Optional[str] = None, **kw):
                field_init(self, *args, **kw)
                self._attach(name)

            cls.__init__ = __init__

    # ------------------------------------------------------------ binding

    def _attach(self, name: Optional[str]) -> None:
        object.__setattr__(self, "_scope", None)
        object.__setattr__(self, "_setup_done", False)
        object.__setattr__(self, "_in_setup", False)
        object.__setattr__(self, "_counters", {})
        object.__setattr__(self, "name", name)
        stack = _stack()
        parent = stack[-1] if stack else None
        if parent is None:
            return
        if parent._in_setup:
            return  # named and bound by the attribute assignment
        if name is None:
            prefix = type(self).__name__
            n = parent._counters.get(prefix, 0)
            parent._counters[prefix] = n + 1
            object.__setattr__(self, "name", f"{prefix}_{n}")
        object.__setattr__(self, "_scope", parent._scope.child(self.name))

    def __setattr__(self, key, value):
        if (isinstance(value, Module) and getattr(self, "_in_setup", False)
                and value._scope is None):
            if value.name is None:
                object.__setattr__(value, "name", key)
            object.__setattr__(value, "_scope", self._scope.child(value.name))
        object.__setattr__(self, key, value)

    def _ensure_setup(self) -> None:
        if self._setup_done:
            return
        object.__setattr__(self, "_setup_done", True)
        object.__setattr__(self, "_in_setup", True)
        try:
            self.setup()
        finally:
            object.__setattr__(self, "_in_setup", False)

    def _bound(self, scope: _Scope) -> "Module":
        m = copy.copy(self)
        object.__setattr__(m, "_scope", scope)
        object.__setattr__(m, "_setup_done", False)
        object.__setattr__(m, "_counters", {})
        return m

    # -------------------------------------------------------------- API

    def setup(self) -> None:
        """Override to create named submodules as attributes."""

    def param(self, name: str, init_fn: Callable, *init_args) -> Array:
        params = self._scope.params
        if name not in params:
            if not self._scope.initializing:
                raise KeyError(f"missing parameter {name!r} in "
                               f"{type(self).__name__}")
            params[name] = init_fn(_fold(self._scope.rng, name), *init_args)
            if self._scope.records is not None:
                self._scope.records.append(
                    ("param", self._scope.path + (name,), init_fn, init_args))
        return params[name]

    def clone(self, **updates) -> "Module":
        """A copy with some hyper-parameters replaced (unbound)."""
        with _Detached():
            return dataclasses.replace(self, **updates)

    def _method(self, method):
        if method is None:
            return type(self).__call__
        if isinstance(method, str):
            return getattr(type(self), method)
        return method

    def init(self, rng: Array, *args, method=None, **kwargs) -> Dict[str, Any]:
        """Create the parameters of running ``method`` (default ``__call__``).

        The method runs once abstractly (``jax.eval_shape``) to find every
        parameter's path, initializer and shape; the values then come from
        the initializers alone, so no forward pass is computed or compiled.
        """
        records: list = []

        def trace(r):
            bound = self._bound(_Scope({}, r, True, records=records))
            self._method(method)(bound, *args, **kwargs)

        jax.eval_shape(trace, rng)
        return {"params": _materialize(records, rng)}

    def apply(self, variables: Dict[str, Any], *args, method=None,
              capture_intermediates: bool = False, mutable=False, **kwargs):
        """Run ``method`` (default ``__call__``) with the given parameters.

        With ``capture_intermediates=True`` every module's ``__call__``
        output is recorded under ``intermediates/<path>/__call__``; pass
        ``mutable=["intermediates"]`` to get ``(out, {"intermediates": ...})``.
        """
        inter = {} if capture_intermediates else None
        bound = self._bound(_Scope(variables["params"], None, False, inter))
        out = self._method(method)(bound, *args, **kwargs)
        if mutable:
            return out, {"intermediates": inter or {}}
        return out


# ---------------------------------------------------------------- layers


def _canon(x: Union[int, Sequence[int]], n: int) -> Tuple[int, ...]:
    return (x,) * n if isinstance(x, int) else tuple(x)


class Dense(Module):
    """``y = x @ kernel + bias``; kernel ``[in, out]``, math in ``dtype``."""

    features: int
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x: Array) -> Array:
        kernel = self.param("kernel", self.kernel_init,
                            (x.shape[-1], self.features), self.param_dtype)
        dtype = self.dtype or jnp.result_type(x, kernel)
        y = lax.dot_general(x.astype(dtype), kernel.astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
        if self.use_bias:
            bias = self.param("bias", self.bias_init, (self.features,),
                              self.param_dtype)
            y = y + bias.astype(dtype)
        return y


class Conv(Module):
    """N-d convolution over channels-last inputs ``[B, *spatial, C]``;
    kernel ``[*kernel_size, in, out]``."""

    features: int
    kernel_size: Sequence[int]
    strides: Union[int, Sequence[int]] = 1
    padding: Union[str, int, Sequence[Tuple[int, int]]] = "SAME"
    use_bias: bool = True
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    kernel_init: Callable = initializers.lecun_normal()
    bias_init: Callable = initializers.zeros

    @compact
    def __call__(self, x: Array) -> Array:
        ks = tuple(self.kernel_size)
        n = len(ks)
        kernel = self.param("kernel", self.kernel_init,
                            ks + (x.shape[-1], self.features), self.param_dtype)
        dtype = self.dtype or jnp.result_type(x, kernel)
        padding = self.padding
        if isinstance(padding, int):
            padding = [(padding, padding)] * n
        spatial = tuple(range(1, n + 1))
        dn = lax.ConvDimensionNumbers(
            lhs_spec=(0, n + 1) + spatial,
            rhs_spec=(n + 1, n) + tuple(range(n)),
            out_spec=(0, n + 1) + spatial)
        y = lax.conv_general_dilated(
            x.astype(dtype), kernel.astype(dtype), _canon(self.strides, n),
            padding, dimension_numbers=dn)
        if self.use_bias:
            bias = self.param("bias", self.bias_init, (self.features,),
                              self.param_dtype)
            y = y + bias.astype(dtype)
        return y


def _normalize(x, mean, var, eps, scale, bias, dtype):
    y = x - mean
    mul = lax.rsqrt(var + eps)
    if scale is not None:
        mul = mul * scale.astype(mul.dtype)
    y = y * mul
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y.astype(dtype)


class LayerNorm(Module):
    """Normalise the last axis; learned ``scale`` and ``bias``."""

    epsilon: float = 1e-6
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    use_bias: bool = True
    use_scale: bool = True

    @compact
    def __call__(self, x: Array) -> Array:
        feat = (x.shape[-1],)
        xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
        mean = jnp.mean(xf, axis=-1, keepdims=True)
        var = jnp.maximum(
            0.0, jnp.mean(xf * xf, axis=-1, keepdims=True) - mean * mean)
        scale = (self.param("scale", initializers.ones, feat, self.param_dtype)
                 if self.use_scale else None)
        bias = (self.param("bias", initializers.zeros, feat, self.param_dtype)
                if self.use_bias else None)
        return _normalize(xf, mean, var, self.epsilon, scale, bias,
                          self.dtype or x.dtype)


class GroupNorm(Module):
    """Normalise over spatial axes and channel groups; per-channel
    ``scale`` and ``bias``."""

    num_groups: int = 32
    epsilon: float = 1e-6
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    use_bias: bool = True
    use_scale: bool = True

    @compact
    def __call__(self, x: Array) -> Array:
        c = x.shape[-1]
        g = self.num_groups
        xf = x.astype(jnp.promote_types(x.dtype, jnp.float32))
        xg = xf.reshape(x.shape[:-1] + (g, c // g))
        axes = tuple(range(1, x.ndim - 1)) + (x.ndim,)
        mean = jnp.mean(xg, axis=axes, keepdims=True)
        var = jnp.maximum(
            0.0, jnp.mean(xg * xg, axis=axes, keepdims=True) - mean * mean)
        mean = jnp.repeat(mean, c // g, axis=-1).reshape(
            mean.shape[:-2] + (c,))
        var = jnp.repeat(var, c // g, axis=-1).reshape(var.shape[:-2] + (c,))
        scale = (self.param("scale", initializers.ones, (c,), self.param_dtype)
                 if self.use_scale else None)
        bias = (self.param("bias", initializers.zeros, (c,), self.param_dtype)
                if self.use_bias else None)
        return _normalize(xf, mean, var, self.epsilon, scale, bias,
                          self.dtype or x.dtype)


class Embed(Module):
    """Lookup table ``embedding [num_embeddings, features]``; out-of-range
    ids read NaN (``jnp.take`` fill mode)."""

    num_embeddings: int
    features: int
    dtype: Optional[Dtype] = None
    param_dtype: Dtype = jnp.float32
    embedding_init: Callable = initializers.variance_scaling(
        1.0, "fan_in", "normal", out_axis=0)

    @compact
    def __call__(self, ids: Array) -> Array:
        table = self.param("embedding", self.embedding_init,
                           (self.num_embeddings, self.features),
                           self.param_dtype)
        if self.dtype is not None:
            table = table.astype(self.dtype)
        return jnp.take(table, ids, axis=0)


# ------------------------------------------------------------ transforms


class _Transformed(Module):
    """A module class built around another: constructor arguments pass
    through to the inner class, whose variables live in this module's own
    subtree (no extra level in the parameter path)."""

    _no_dataclass = True
    _inner_cls: type = None

    def __init__(self, *args, name: Optional[str] = None, **kwargs):
        object.__setattr__(self, "_args", args)
        object.__setattr__(self, "_kwargs", kwargs)
        self._attach(name)

    def _run(self, scope: _Scope, *args):
        with _Detached():
            inner = self._inner_cls(*self._args, **self._kwargs)
        return inner._bound(scope)(*args)


def remat(cls: type, prevent_cse: bool = True) -> type:
    """Rematerialise the module's activations in the backward pass."""

    class Remat(_Transformed):
        _inner_cls = cls

        def __call__(self, *args):
            scope = self._scope
            if scope.initializing or scope.intermediates is not None:
                return self._run(scope, *args)

            def f(params, args):
                return self._run(_Scope(params, None, False), *args)

            return jax.checkpoint(f, prevent_cse=prevent_cse)(
                scope.params, args)

    Remat.__name__ = cls.__name__
    return Remat


def map_variables(cls: type, collection: str = "params",
                  trans_in_fn: Callable = lambda v: v) -> type:
    """Transform the module's parameters before each use (not at init)."""
    if collection != "params":
        raise ValueError("map_variables supports the 'params' collection")

    class MapVariables(_Transformed):
        _inner_cls = cls

        def __call__(self, *args):
            scope = self._scope
            if scope.initializing:
                return self._run(scope, *args)
            mapped = _Scope(trans_in_fn(scope.params), None, False,
                            scope.intermediates)
            return self._run(mapped, *args)

    MapVariables.__name__ = cls.__name__
    return MapVariables


def scan(cls: type, variable_axes=None, split_rngs=None, length: int = None,
         in_axes: Union[int, _Broadcast, Tuple] = 0, out_axes: int = 0) -> type:
    """Apply the module ``length`` times as ``lax.scan``:
    ``(carry, *xs) -> (carry, stacked ys)``.

    Every layer has its own parameters, stacked on axis 0 (fresh random
    values per layer at init). ``in_axes`` gives, per ``xs`` argument,
    ``0`` (sliced per layer) or ``broadcast`` (passed whole).
    """
    del variable_axes, split_rngs  # params stacked on axis 0, rngs split
    if out_axes != 0:
        raise ValueError("scan supports out_axes=0")

    class Scan(_Transformed):
        _inner_cls = cls

        def __call__(self, carry, *xs):
            axes = in_axes if isinstance(in_axes, tuple) else (in_axes,) * len(xs)
            if len(axes) != len(xs):
                raise ValueError(f"scan got {len(xs)} inputs for in_axes "
                                 f"{in_axes}")
            scanned = tuple(x for x, a in zip(xs, axes) if a is not broadcast)

            def merge(sliced):
                it = iter(sliced)
                return tuple(x if a is broadcast else next(it)
                             for x, a in zip(xs, axes))

            scope = self._scope
            if scope.initializing:
                # init runs abstractly (Module.init): one trace of a layer
                # finds its parameters, and _materialize makes each layer's
                # values, so the layer's forward is never batched over layers.
                first = jax.tree_util.tree_map(lambda a: a[0], scanned)
                inner_records: list = []
                inner = _Scope({}, _fold(scope.rng, "scan"), True, records=inner_records)
                self._run(inner, carry, *merge(first))
                scope.params.update(jax.tree_util.tree_map(
                    lambda a: jnp.broadcast_to(a, (length,) + a.shape), inner.params))
                if scope.records is not None:
                    scope.records.append(("scan", scope.path, length, inner_records))

            capture = scope.intermediates is not None

            def body(c, sl):
                p, x = sl
                inter = {} if capture else None
                c, y = self._run(_Scope(p, None, False, inter), c, *merge(x))
                return c, (y, inter)

            carry, (ys, inters) = lax.scan(
                body, carry, (scope.params, scanned), length=length)
            if capture:
                scope.intermediates.update(inters)
            return carry, ys

    Scan.__name__ = cls.__name__
    return Scan
