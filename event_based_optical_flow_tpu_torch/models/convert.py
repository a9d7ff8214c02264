"""EV-FlowNet weights carried between the JAX package's flax parameters and
the port's ``state_dict``.

The flax tree (``model.init(...)``'s ``{"params": ...}`` or its inner dict,
as nested dicts of numpy arrays) names modules by type and creation order:
``ConvBlock_<i>`` (the encoders), ``ResidualBlock_<i>/ConvBlock_<j>``,
``UpsampleConvAndPredict_<i>`` (``Conv_0`` the 3x3 conv, ``Conv_1`` the
flow head), each with ``Conv_<k>/{kernel, bias}`` and, with ``use_norm``,
``GroupNorm_0/{scale, bias}``.  Kernels are HWIO there and OIHW here.
"""

from typing import Dict

import numpy as np
import torch

_MODULES = (("ConvBlock", "encoders"), ("ResidualBlock", "residuals"), ("UpsampleConvAndPredict", "decoders"))
_LEAVES = {("Conv_0", "kernel"): "conv.weight", ("Conv_0", "bias"): "conv.bias",
           ("Conv_1", "kernel"): "head.weight", ("Conv_1", "bias"): "head.bias",
           ("GroupNorm_0", "scale"): "norm.weight", ("GroupNorm_0", "bias"): "norm.bias"}


def _flatten(tree: dict, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_name(path) -> str:
    top, *rest = path
    kind, index = top.rsplit("_", 1)
    name = f"{dict(_MODULES)[kind]}.{index}"
    if kind == "ResidualBlock":
        inner, *rest = rest
        name += f".blocks.{inner.rsplit('_', 1)[1]}"
    return f"{name}.{_LEAVES[tuple(rest)]}"


def params_from_flax(tree: dict) -> Dict[str, torch.Tensor]:
    """The port's ``EVFlowNet`` ``state_dict`` of a flax parameter tree
    (values keep their dtype)."""
    tree = tree.get("params", tree)
    out = {}
    for path, value in _flatten(tree):
        value = np.asarray(value)
        if path[-1] == "kernel":
            value = value.transpose(3, 2, 0, 1)
        out[_torch_name(path)] = torch.tensor(value)  # a copy: the source may be a read-only view
    return out


def params_to_flax(state_dict: Dict[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_flax``: ``{"params": nested dicts of
    numpy arrays}`` in the flax layout."""
    from_torch = {v: k for k, v in _LEAVES.items()}
    to_flax = {v: k for k, v in _MODULES}
    params: dict = {}
    for name, value in state_dict.items():
        parts = name.split(".")
        path = [f"{to_flax[parts[0]]}_{parts[1]}"]
        rest = parts[2:]
        if parts[0] == "residuals":
            path.append(f"ConvBlock_{rest[1]}")
            rest = rest[2:]
        module, leaf = from_torch[".".join(rest)]
        array = value.detach().cpu().numpy()
        if leaf == "kernel":
            array = array.transpose(2, 3, 1, 0)
        node = params
        for key in path + [module]:
            node = node.setdefault(key, {})
        node[leaf] = np.ascontiguousarray(array)
    return {"params": params}
