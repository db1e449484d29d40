"""Plain-JAX model base: explicit parameter dicts behind an init/apply surface.

Each model is a small Python object holding its configuration. Its
methods take the parameter dict as their first argument, so
``model.apply({"params": p}, x, method=model.encode)`` is simply
``model.encode(p, x)``. ``model.init(rng, *inputs)`` returns
``{"params": ...}`` with the tree paths, names and shapes that
checkpoints store.

Initial weights are drawn per parameter from a key derived as
``flax.linen`` derived it (SHA-1 of the module path and the parameter's
creation index, folded into the root key), so a seed gives the same
initial weights as the checkpoints written by earlier versions.
"""

from __future__ import annotations

import hashlib
from typing import Any, Callable, Dict, Sequence

import jax
import jax.numpy as jnp
import numpy as np

Params = Dict[str, Any]

lecun_normal = jax.nn.initializers.lecun_normal()
orthogonal = jax.nn.initializers.orthogonal()
zeros = jax.nn.initializers.zeros


def normal(stddev: float):
    return jax.nn.initializers.normal(stddev)


def _fold_in_path(rng: jax.Array, path: Sequence) -> jax.Array:
    m = hashlib.sha1()
    for x in path:
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, "big"))
    h = int.from_bytes(m.digest()[:4], "big")
    return jax.random.fold_in(rng, np.uint32(h))


class ParamKeys:
    """Creates the parameters of one module scope, in creation order."""

    def __init__(self, rng: jax.Array, path: Sequence[str] = ()):
        self.rng = rng
        self.path = tuple(path)
        self.count = 0

    def child(self, name: str) -> "ParamKeys":
        return ParamKeys(self.rng, self.path + (name,))

    def __call__(self, init: Callable, shape) -> jax.Array:
        self.count += 1
        key = _fold_in_path(self.rng, self.path + (self.count,))
        return init(key, tuple(shape), jnp.float32)


class Module:
    """``init``/``apply`` over explicit parameter dicts.

    Subclasses implement ``init_params(keys, *inputs)`` (the inputs are
    the example arguments ``init`` was given; only their shapes matter)
    and methods of the form ``method(params, *args)``."""

    def init(self, rng: jax.Array, *inputs, **kwargs) -> Dict[str, Params]:
        return {"params": self.init_params(ParamKeys(rng), *inputs, **kwargs)}

    def init_params(self, keys: ParamKeys, *inputs, **kwargs) -> Params:
        raise NotImplementedError

    def apply(self, variables: Dict[str, Params], *args, method=None,
              **kwargs):
        fn = self.__call__ if method is None else method
        return fn(variables["params"], *args, **kwargs)


# ----------------------------------------------------------------------
# Layers shared by the models
# ----------------------------------------------------------------------

def dense_params(keys: ParamKeys, d_in: int, d_out: int) -> Params:
    return {"kernel": keys(lecun_normal, (d_in, d_out)),
            "bias": keys(zeros, (d_out,))}


def dense(p: Params, x: jax.Array, dtype) -> jax.Array:
    """``x @ kernel + bias`` with all three cast to ``dtype``."""
    x = x.astype(dtype)
    y = jax.lax.dot_general(x, p["kernel"].astype(dtype),
                            (((x.ndim - 1,), (0,)), ((), ())))
    return y + p["bias"].astype(dtype).reshape((1,) * (y.ndim - 1) + (-1,))


def conv2d_params(keys: ParamKeys, c_in: int, c_out: int) -> Params:
    return {"kernel": keys(lecun_normal, (3, 3, c_in, c_out)),
            "bias": keys(zeros, (c_out,))}


def conv2d_same(p: Params, x: jax.Array, dtype) -> jax.Array:
    """3x3 SAME convolution over NHWC input, kernel HWIO."""
    x = x.astype(dtype)
    y = jax.lax.conv_general_dilated(
        x, p["kernel"].astype(dtype), (1, 1), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + p["bias"].astype(dtype).reshape((1, 1, 1, -1))


def max_pool_2x2(x: jax.Array) -> jax.Array:
    """2x2 max-pool, stride 2, SAME padding (ceil on both axes)."""
    return jax.lax.reduce_window(x, -jnp.inf, jax.lax.max, (1, 2, 2, 1),
                                 (1, 2, 2, 1), "SAME")


def dropout(x: jax.Array, rate: float, rng: jax.Array) -> jax.Array:
    """Inverted dropout: keep with probability 1 - rate, scale by 1/keep."""
    if rate == 0.0:
        return x
    if rate == 1.0:
        return jnp.zeros_like(x)
    keep = 1.0 - rate
    mask = jax.random.bernoulli(rng, p=keep, shape=x.shape)
    return jax.lax.select(mask, x / keep, jnp.zeros_like(x))
