"""Pytree registration for framework classes.

Operators, smoothers, transfers, and the GMG hierarchy hold large device
arrays (patch inverses, geometry tables).  If those are merely closed over by
a jitted function they become HLO *constants* -- bloating the serialized
program (multi-hundred-MB constants slow every compile) and preventing
donation.  Registering the classes as pytrees makes the arrays
proper jit ARGUMENTS: call jitted functions with the module objects as
parameters.

Leaf detection is automatic: any attribute whose tree contains a jax.Array
(including lists/tuples/dicts of arrays or of other registered modules)
becomes a child; everything else is static.  Static state is compared by
identity, so rebuilding a module triggers a recompile (same behavior as
constant-baking, without the payload).
"""
from __future__ import annotations

import jax
import jax.tree_util as jtu


class _Static:
    """Identity-hashed wrapper for the non-array state of a module."""

    __slots__ = ("obj",)

    def __init__(self, obj):
        self.obj = obj

    def __hash__(self):
        return id(self.obj)

    def __eq__(self, other):
        return isinstance(other, _Static) and self.obj is other.obj


def _contains_array(v) -> bool:
    return any(isinstance(l, jax.Array)
               for l in jtu.tree_leaves(v))


def register_module(cls):
    """Class decorator: register as a JAX pytree with auto leaf detection."""

    def flatten(obj):
        aux = obj.__dict__.get("_module_aux")
        if aux is None:
            d = vars(obj)
            leaf_keys = tuple(sorted(
                k for k, v in d.items()
                if k != "_module_aux" and _contains_array(v)))
            static = {k: v for k, v in d.items()
                      if k not in leaf_keys and k != "_module_aux"}
            aux = (leaf_keys, _Static(static))
            obj.__dict__["_module_aux"] = aux
        leaf_keys, _ = aux
        return [obj.__dict__[k] for k in leaf_keys], aux

    def unflatten(aux, leaves):
        leaf_keys, static = aux
        obj = object.__new__(cls)
        obj.__dict__.update(static.obj)
        for k, v in zip(leaf_keys, leaves):
            obj.__dict__[k] = v
        obj.__dict__["_module_aux"] = aux
        return obj

    jtu.register_pytree_node(cls, flatten, unflatten)
    return cls
