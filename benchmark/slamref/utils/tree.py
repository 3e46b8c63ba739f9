"""The port's NamedTuple trees of tensors (nested NamedTuples included):
stacked along a new leading axis, as JAX's ``lax.scan`` drives stack
their outputs, joined along the leading axis, and flattened."""

from __future__ import annotations

import torch


def _join(op, outs):
    first = outs[0]
    if first is None:
        return None
    if isinstance(first, torch.Tensor):
        return op(outs)
    return type(first)(*(_join(op, [getattr(o, f) for o in outs]) for f in first._fields))


def stack(outs):
    """Stack a list of like trees along a new leading axis; None fields
    stay None."""
    return _join(torch.stack, outs)


def cat(outs):
    """Join a list of like trees of stacked tensors along their leading
    axis; None fields stay None."""
    return _join(torch.cat, outs)


def leaves(x) -> list:
    """The tensors of a tree, in field order; None fields are left out."""
    if x is None:
        return []
    if isinstance(x, torch.Tensor):
        return [x]
    return [leaf for field in x for leaf in leaves(field)]
