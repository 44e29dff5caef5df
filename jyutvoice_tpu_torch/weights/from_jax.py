"""Load the JAX package's parameter trees into this package's modules, and
turn the modules back into such trees.

A JAX parameter tree is nested dicts and lists of arrays, as `init_tts` /
`init_hift` return them or as `save_pytree_npz` writes them. The modules of
this package carry the same names along the same paths, so the bridge only
changes layouts, leaf module by leaf module:

  Linear           {"w": (Cin, Cout), "b"}   -> weight (Cout, Cin), bias
  Conv1d           {"w": (K, Cin, Cout), "b"} -> weight (Cout, Cin, K), bias
  ConvTranspose1d  {"w": (K, Cin, Cout), "b"} -> weight (Cin, Cout, K), bias
  Conv2d           {"w": (KH, KW, Cin, Cout), "b"} -> weight (Cout, Cin, KH, KW), bias
  DepthwiseConv1d  {"w": (K, C), "b"}         -> weight (C, K), bias
  BatchNorm        {"mean", "var", "gamma", "beta"} -> running_mean,
                   running_var, weight, bias (no gamma/beta: affine=False)
  LayerNorm        {"g", "b"}                -> weight, bias
  Embedding        {"w": (V, D)}             -> weight (V, D)
  QuantLinear      {"w_q": int8 (Cin, Cout), "scale": (Cout,), "b"}
                   -> w_q int8 (Cout, Cin), scale, bias (the int8 leaves of
                   `nn/quant.py::quantize_estimator`)
  ParameterList    [arrays]                  -> one parameter each
  a module's own parameter (e.g. RelMHA.pos_bias_u, S3Tokenizer.pos)
                   array under its name      -> that parameter

A module that names children in `QUANTIZABLE` (the estimator's attention
projections and feed-forward linears) takes a `QuantLinear` in place of its
`Linear` there when the tree's leaf holds `w_q`: the counterpart of the JAX
package's `maybe_linear`, which picks the int8 path by tree structure.

It is strict both ways: a tree leaf that no parameter takes, a parameter (or
a leaf module's buffer, such as `w_q`) that no leaf fills, or a shape that
differs raises ValueError. Leaves load as float32, except `w_q`, which must
be int8 and stays so.
`jax_params_from_module` is its inverse: it undoes each layout change and
raises when a parameter would be left out of the tree or a leaf module lacks
one of its required parameters, so a model trained with this package goes
back to the JAX layout (and on to the reference's state_dict through
`weights/torch_export.py`). `save_pytree_npz` / `load_pytree_npz` write and
read trees in the JAX package's `.npz` format.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from jyutvoice_tpu_torch.nn import core
from jyutvoice_tpu_torch.nn.quant import QuantLinear

# leaf module type -> {tree key: (parameter name, numpy axes permutation)}
_LEAVES = {
    core.Linear: {"w": ("weight", (1, 0)), "b": ("bias", None)},
    core.Conv1d: {"w": ("weight", (2, 1, 0)), "b": ("bias", None)},
    core.ConvTranspose1d: {"w": ("weight", (1, 2, 0)), "b": ("bias", None)},
    core.Conv2d: {"w": ("weight", (3, 2, 0, 1)), "b": ("bias", None)},
    core.DepthwiseConv1d: {"w": ("weight", (1, 0)), "b": ("bias", None)},
    core.BatchNorm: {"mean": ("running_mean", None), "var": ("running_var", None),
                     "gamma": ("weight", None), "beta": ("bias", None)},
    core.LayerNorm: {"g": ("weight", None), "b": ("bias", None)},
    core.Embedding: {"w": ("weight", None)},
    QuantLinear: {"w_q": ("w_q", (1, 0)), "scale": ("scale", None), "b": ("bias", None)},
}


def _leaf_buffers(module: nn.Module):
    """(name, buffer) of every buffer a leaf module takes from the tree (a
    QuantLinear's w_q and scale), for the strictness checks beside the
    parameters."""
    for mname, m in module.named_modules():
        for name, _ in _LEAVES.get(type(m), {}).values():
            t = getattr(m, name)
            if t is not None and not isinstance(t, nn.Parameter):
                yield f"{mname}.{name}" if mname else name, t


def _fill(param: torch.Tensor, value, path: str, filled: set) -> None:
    if param.dtype == torch.int8:
        arr = np.array(value)  # a writable copy
        if arr.dtype != np.int8:
            raise ValueError(f"{path}: an int8 leaf, got {arr.dtype}")
    else:
        arr = np.array(value, dtype=np.float32)
    if tuple(arr.shape) != tuple(param.shape):
        raise ValueError(
            f"{path}: tree shape {tuple(arr.shape)} does not fit parameter "
            f"shape {tuple(param.shape)}"
        )
    with torch.no_grad():
        param.copy_(torch.from_numpy(arr))
    filled.add(id(param))


def _load(module: nn.Module, node, path: str, filled: set) -> None:
    spec = _LEAVES.get(type(module))
    if spec is not None:
        if not isinstance(node, dict):
            raise ValueError(f"{path}: expected a dict of arrays")
        wanted = {k for k, (name, _) in spec.items() if getattr(module, name) is not None}
        if set(node) != wanted:
            raise ValueError(
                f"{path}: tree keys {sorted(node)} do not match {sorted(wanted)}"
            )
        for key, (name, perm) in spec.items():
            if key in node:
                arr = np.asarray(node[key])
                _fill(getattr(module, name), arr.transpose(perm) if perm else arr,
                      f"{path}/{key}", filled)
        return
    if isinstance(module, nn.ParameterList):
        if not isinstance(node, (list, tuple)) or len(node) != len(module):
            raise ValueError(f"{path}: expected a list of {len(module)} arrays")
        for i, (p, v) in enumerate(zip(module, node)):
            _fill(p, v, f"{path}/{i}", filled)
        return
    if isinstance(module, nn.ModuleList):
        if not isinstance(node, (list, tuple)) or len(node) != len(module):
            raise ValueError(f"{path}: expected a list of {len(module)} subtrees")
        for i, (m, v) in enumerate(zip(module, node)):
            _load(m, v, f"{path}/{i}", filled)
        return
    children = dict(module.named_children())
    own = dict(module.named_parameters(recurse=False))
    if not isinstance(node, dict):
        raise ValueError(f"{path}: expected a dict subtree")
    extra = sorted(set(node) - set(children) - set(own))
    missing = sorted((set(children) | set(own)) - set(node))
    if extra or missing:
        raise ValueError(
            f"{path or '<root>'}: tree keys not taken {extra}, modules not filled {missing}"
        )
    for name, param in own.items():
        _fill(param, node[name], f"{path}/{name}" if path else name, filled)
    for name, child in children.items():
        if (name in getattr(module, "QUANTIZABLE", ()) and type(child) is core.Linear
                and isinstance(node[name], dict) and "w_q" in node[name]):
            out_dim, in_dim = child.weight.shape
            child = QuantLinear(in_dim, out_dim, bias=child.bias is not None)
            setattr(module, name, child)
        _load(child, node[name], f"{path}/{name}" if path else name, filled)


def load_jax_params(module: nn.Module, tree) -> nn.Module:
    """Copy a JAX parameter tree into `module` in place; returns the module.
    Its QUANTIZABLE linears whose leaves hold w_q become `QuantLinear`."""
    filled: set = set()
    _load(module, tree, "", filled)
    unfilled = [n for n, p in (*module.named_parameters(), *_leaf_buffers(module))
                if id(p) not in filled]
    if unfilled:
        raise ValueError(f"parameters not filled by the tree: {unfilled}")
    return module


# leaves a leaf module may lack: biases, and a batch norm's affine pair
_OPTIONAL = {"b", "gamma", "beta"}


def _array(t: torch.Tensor, perm) -> np.ndarray:
    arr = t.detach().cpu().numpy()
    if perm:
        arr = arr.transpose(np.argsort(perm))
    # a contiguous copy; int8 leaves (QuantLinear.w_q) stay int8
    return np.array(arr, dtype=np.int8 if t.dtype == torch.int8 else np.float32)


def _unload(module: nn.Module, path: str, taken: set):
    spec = _LEAVES.get(type(module))
    if spec is not None:
        node = {}
        for key, (name, perm) in spec.items():
            t = getattr(module, name)
            if t is None:
                if key not in _OPTIONAL:
                    raise ValueError(f"{path}: the module has no {name} for the leaf {key!r}")
                continue
            node[key] = _array(t, perm)
            taken.add(id(t))
        return node
    if isinstance(module, nn.ParameterList):
        taken.update(id(p) for p in module)
        return [_array(p, None) for p in module]
    if isinstance(module, nn.ModuleList):
        return [_unload(m, f"{path}/{i}", taken) for i, m in enumerate(module)]
    node = {}
    for name, param in module.named_parameters(recurse=False):
        node[name] = _array(param, None)
        taken.add(id(param))
    for name, child in module.named_children():
        node[name] = _unload(child, f"{path}/{name}" if path else name, taken)
    return node


def jax_params_from_module(module: nn.Module):
    """The JAX-layout parameter tree (numpy float32 arrays, int8 for a
    `QuantLinear`'s w_q) of `module`: the inverse of `load_jax_params`, so
    that `load_jax_params(fresh, tree)` reproduces the module's parameters
    and leaf buffers bit for bit."""
    taken: set = set()
    tree = _unload(module, "", taken)
    left = [n for n, p in (*module.named_parameters(), *_leaf_buffers(module))
            if id(p) not in taken]
    if left:
        raise ValueError(f"parameters left out of the tree: {left}")
    return tree


# ---------------------------------------------------------------------------
# .npz trees (the JAX package's save_pytree_npz format: "a/b/0/w" keys)
# ---------------------------------------------------------------------------


def _flatten(tree, prefix=""):
    """nested dicts and lists -> {"a/b/0/w": array}."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = np.asarray(tree)
    return out


def _listify(node):
    if isinstance(node, dict):
        keys = list(node.keys())
        if keys and all(k.isdigit() for k in keys):
            return [_listify(node[str(i)]) for i in range(len(keys))]
        return {k: _listify(v) for k, v in node.items()}
    return node


def unflatten(flat: Dict[str, np.ndarray]):
    """{"a/b/0/w": array} -> nested dicts, with all-digit keys as lists."""
    root: dict = {}
    for key, val in flat.items():
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return _listify(root)


def save_pytree_npz(path: str, tree) -> None:
    """Write a parameter tree as the JAX package's `save_pytree_npz` does."""
    np.savez(path, **_flatten(tree))


def load_pytree_npz(path: str):
    """A parameter tree saved by the JAX package's `save_pytree_npz`."""
    with np.load(path) as data:
        return unflatten({k: data[k] for k in data.files})


# ---------------------------------------------------------------------------
# Streaming state
# ---------------------------------------------------------------------------


def flow_stream_state_from_jax(state, device="cpu"):
    """The JAX package's `FlowEncoderStreamState` (fields offset,
    conv2_cache, enc_kv, up_conv_cache, up_kv; leaves as numpy arrays or
    anything np.asarray takes) as this package's, on `device`: the same
    layouts ((B, 2, d) conv cache, (B, H, T_max, D) keys and values), the
    offset a host int. A stream started in one package continues in the
    other."""
    from jyutvoice_tpu_torch.models.flow_encoder import FlowEncoderStreamState

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(device)

    def kv(caches):
        return [{"k": t(c["k"]), "v": t(c["v"])} for c in caches]

    return FlowEncoderStreamState(
        offset=int(np.asarray(state.offset)), conv2_cache=t(state.conv2_cache),
        enc_kv=kv(state.enc_kv), up_conv_cache=t(state.up_conv_cache), up_kv=kv(state.up_kv),
    )
