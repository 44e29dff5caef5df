"""CAM++ weight conversion: torch state_dict / ONNX initializers -> the JAX
package's tree layout (numpy), which `models/campplus.py::build_campplus`
loads through `weights/from_jax.py`.

A copy of the JAX package's `weights/campplus_convert.py`. The real artifact
is campplus.onnx (reference infer.py:355-362), an export of the 3D-Speaker
CAMPPlus module. Two entry points:

  * campplus_from_flat(dict)  — name-based, for torch state_dicts and ONNX
    exports that preserve module-path initializer names.
  * campplus_from_onnx(path)  — reads the ONNX protobuf with the dependency-
    free reader (weights/onnx_reader.py), tries the name-based map, and
    falls back to structural binding (walk Conv/BatchNormalization nodes in
    graph order) for exports with folded/renamed initializers.

Layouts follow the repo conventions: conv1d (K, Cin, Cout); conv2d NHWC
(KH, KW, Cin, Cout); 1x1 convs stored as linear (Cin, Cout).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from jyutvoice_tpu_torch.models.campplus import CampPlusConfig

Flat = Dict[str, np.ndarray]


def _bn(flat: Flat, name: str, affine: bool = True) -> dict:
    p = {
        "mean": flat[f"{name}.running_mean"],
        "var": flat[f"{name}.running_var"],
    }
    if affine:
        p["gamma"] = flat[f"{name}.weight"]
        p["beta"] = flat[f"{name}.bias"]
    return p


def _conv2d(flat: Flat, name: str) -> dict:
    return {"w": flat[f"{name}.weight"].transpose(2, 3, 1, 0)}


def _conv1d(flat: Flat, name: str) -> dict:
    p = {"w": flat[f"{name}.weight"].transpose(2, 1, 0)}
    if f"{name}.bias" in flat:
        p["b"] = flat[f"{name}.bias"]
    return p


def _lin1x1(flat: Flat, name: str) -> dict:
    w = flat[f"{name}.weight"]
    p = {"w": w[:, :, 0].T if w.ndim == 3 else w.T}
    if f"{name}.bias" in flat:
        p["b"] = flat[f"{name}.bias"]
    return p


def _res_block(flat: Flat, name: str) -> dict:
    p = {
        "conv1": _conv2d(flat, f"{name}.conv1"),
        "bn1": _bn(flat, f"{name}.bn1"),
        "conv2": _conv2d(flat, f"{name}.conv2"),
        "bn2": _bn(flat, f"{name}.bn2"),
    }
    if f"{name}.shortcut.0.weight" in flat:
        p["sc_conv"] = _conv2d(flat, f"{name}.shortcut.0")
        p["sc_bn"] = _bn(flat, f"{name}.shortcut.1")
    return p


def campplus_from_flat(
    flat: Flat, cfg: CampPlusConfig = CampPlusConfig()
) -> dict:
    """Name-based conversion from speakerlab module-path names."""
    p = {
        "head": {
            "conv1": _conv2d(flat, "head.conv1"),
            "bn1": _bn(flat, "head.bn1"),
            "layer1": [_res_block(flat, f"head.layer1.{i}") for i in range(2)],
            "layer2": [_res_block(flat, f"head.layer2.{i}") for i in range(2)],
            "conv2": _conv2d(flat, "head.conv2"),
            "bn2": _bn(flat, "head.bn2"),
        },
        "tdnn": {
            "conv": _conv1d(flat, "xvector.tdnn.linear"),
            "bn": _bn(flat, "xvector.tdnn.nonlinear.batchnorm"),
        },
        "blocks": [],
    }
    for i, n_layers in enumerate(cfg.num_layers):
        layers = []
        for j in range(n_layers):
            base = f"xvector.block{i + 1}.tdnnd{j + 1}"
            layers.append(
                {
                    "bn1": _bn(flat, f"{base}.nonlinear1.batchnorm"),
                    "linear1": _lin1x1(flat, f"{base}.linear1"),
                    "bn2": _bn(flat, f"{base}.nonlinear2.batchnorm"),
                    "cam": {
                        "local": _conv1d(flat, f"{base}.cam_layer.linear_local"),
                        "lin1": _lin1x1(flat, f"{base}.cam_layer.linear1"),
                        "lin2": _lin1x1(flat, f"{base}.cam_layer.linear2"),
                    },
                }
            )
        p["blocks"].append(
            {
                "layers": layers,
                "transit": {
                    "bn": _bn(flat, f"xvector.transit{i + 1}.nonlinear.batchnorm"),
                    "linear": _lin1x1(flat, f"xvector.transit{i + 1}.linear"),
                },
            }
        )
    p["out_bn"] = _bn(flat, "xvector.out_nonlinear.batchnorm")
    p["dense"] = {
        "linear": _lin1x1(flat, "xvector.dense.linear"),
        "bn": _bn(flat, "xvector.dense.nonlinear.batchnorm", affine=False),
    }
    return p


# ---------------------------------------------------------------------------
# Structural ONNX binding (name-agnostic fallback)
# ---------------------------------------------------------------------------

# Expected slot sequence in execution (= ONNX trace) order. Each slot is
# ("conv", path, torch_weight_shape_hint) or ("bn", path, channels).
# `path` is a tuple of pytree keys/indices into the converted params.


def _expected_slots(cfg: CampPlusConfig) -> List[Tuple[str, tuple, tuple]]:
    m = cfg.m_channels
    slots: List[Tuple[str, tuple, tuple]] = []

    def conv(path, shape):
        slots.append(("conv", path, tuple(shape)))

    def bn(path, ch):
        slots.append(("bn", path, (ch,)))

    conv(("head", "conv1"), (m, 1, 3, 3))
    bn(("head", "bn1"), m)
    for li, layer in enumerate(("layer1", "layer2")):
        for bi in range(2):
            base = ("head", layer, bi)
            conv(base + ("conv1",), (m, m, 3, 3))
            bn(base + ("bn1",), m)
            conv(base + ("conv2",), (m, m, 3, 3))
            bn(base + ("bn2",), m)
            if bi == 0:  # stride-2 block has a projection shortcut
                conv(base + ("sc_conv",), (m, m, 1, 1))
                bn(base + ("sc_bn",), m)
    conv(("head", "conv2"), (m, m, 3, 3))
    bn(("head", "bn2"), m)

    ch = cfg.fcm_out_channels
    conv(("tdnn", "conv"), (cfg.init_channels, ch, 5))
    bn(("tdnn", "bn"), cfg.init_channels)
    ch = cfg.init_channels
    bn_ch = cfg.bn_size * cfg.growth_rate
    for i, (n_layers, k, _d) in enumerate(
        zip(cfg.num_layers, cfg.kernel_sizes, cfg.dilations)
    ):
        for j in range(n_layers):
            base = ("blocks", i, "layers", j)
            in_ch = ch + j * cfg.growth_rate
            bn(base + ("bn1",), in_ch)
            conv(base + ("linear1",), (bn_ch, in_ch, 1))
            bn(base + ("bn2",), bn_ch)
            conv(base + ("cam", "local"), (cfg.growth_rate, bn_ch, k))
            conv(base + ("cam", "lin1"), (bn_ch // 2, bn_ch, 1))
            conv(base + ("cam", "lin2"), (cfg.growth_rate, bn_ch // 2, 1))
        ch = ch + n_layers * cfg.growth_rate
        bn(("blocks", i, "transit", "bn"), ch)
        conv(("blocks", i, "transit", "linear"), (ch // 2, ch, 1))
        ch //= 2
    bn(("out_bn",), ch)
    conv(("dense", "linear"), (cfg.embedding_size, ch * 2, 1))
    bn(("dense", "bn"), cfg.embedding_size)
    return slots


def _set_path(tree: dict, path: tuple, value):
    node = tree
    for key, nxt in zip(path[:-1], path[1:]):
        if isinstance(key, int):
            while len(node) <= key:
                node.append([] if isinstance(nxt, int) else {})
            node = node[key]
        else:
            if key not in node:
                node[key] = [] if isinstance(nxt, int) else {}
            node = node[key]
    node[path[-1]] = value


def _convert_conv_weight(w: np.ndarray, hint: tuple) -> dict:
    if w.ndim == 4:
        return {"w": w.transpose(2, 3, 1, 0)}
    if w.ndim == 3 and w.shape[2] == 1 and hint[-1] == 1:
        return {"w": w[:, :, 0].T}  # 1x1 -> linear layout
    if w.ndim == 3:
        return {"w": w.transpose(2, 1, 0)}
    if w.ndim == 2:
        return {"w": w.T}
    raise ValueError(f"unsupported conv weight rank {w.shape}")


def campplus_from_onnx_graph(
    nodes: List[dict],
    initializers: Flat,
    cfg: CampPlusConfig = CampPlusConfig(),
) -> dict:
    """Bind ONNX Conv/BatchNormalization nodes (graph order = trace order)
    onto the expected slot sequence. BN slots skipped over when a later conv
    arrives are BNs the exporter folded into the preceding conv — they are
    filled with identity stats.
    """
    slots = _expected_slots(cfg)
    params: dict = {}
    pos = 0

    # torch's exporter dedupes identical tensors behind Identity nodes
    # (e.g. fresh BN running stats aliased to the ones/zeros scale/bias)
    # and emits synthesized constants (affine-less BN scale/bias) as
    # Constant nodes; resolve both so node inputs hit real tensors.
    alias: Dict[str, str] = {}
    consts: Dict[str, np.ndarray] = {}
    for node in nodes:
        if node["op_type"] == "Identity" and node["input"]:
            src = node["input"][0]
            alias[node["output"][0]] = alias.get(src, src)
        elif node["op_type"] == "Constant" and "value" in node.get("attrs", {}):
            consts[node["output"][0]] = node["attrs"]["value"]

    def _init(name: str) -> Optional[np.ndarray]:
        name = alias.get(name, name)
        if name in initializers:
            return initializers[name]
        return consts.get(name)

    def fill_identity_bn(slot):
        _kind, path, (ch,) = slot
        _set_path(
            params,
            path,
            {
                "gamma": np.ones(ch, np.float32),
                "beta": np.zeros(ch, np.float32),
                "mean": np.zeros(ch, np.float32),
                "var": np.ones(ch, np.float32),
            },
        )

    for node in nodes:
        op = node["op_type"]
        ins = node["input"]
        if op in ("Conv", "Gemm", "MatMul"):
            weights = [a for a in (_init(n) for n in ins) if a is not None]
            if not weights:
                continue
            w = weights[0]
            # Orient 2-D weights to (Cout, Cin) from the op's own semantics,
            # never from shape hints (a square/coincidentally-matching shape
            # would silently bind a transposed weight): Conv stores
            # (Cout, Cin, k...); Gemm stores (Cout, Cin) iff transB=1;
            # MatMul always stores (Cin, Cout).
            if w.ndim == 2 and (
                op == "MatMul"
                or (op == "Gemm" and not node.get("attrs", {}).get("transB", 0))
            ):
                w = w.T
            # advance to the next conv slot, folding skipped BNs to identity
            while pos < len(slots) and slots[pos][0] != "conv":
                fill_identity_bn(slots[pos])
                pos += 1
            if pos >= len(slots):
                raise ValueError(f"unexpected extra {op} node {node['name']}")
            _kind, path, hint = slots[pos]
            if w.shape[0] != hint[0] or w.shape[1] != hint[1]:
                raise ValueError(
                    f"{op} weight {w.shape} does not match expected slot "
                    f"{hint} at {path}"
                )
            p = _convert_conv_weight(w, hint)
            if len(weights) > 1:
                p["b"] = weights[1].reshape(-1)
            _set_path(params, path, p)
            pos += 1
        elif op == "BatchNormalization":
            if pos >= len(slots) or slots[pos][0] != "bn":
                raise ValueError(
                    f"BatchNormalization node {node['name']} does not align "
                    f"with expected slot {slots[pos] if pos < len(slots) else None}"
                )
            _kind, path, (ch,) = slots[pos]
            scale, bias, mean, var = (_init(n) for n in ins[1:5])
            _set_path(
                params,
                path,
                {"gamma": scale, "beta": bias, "mean": mean, "var": var},
            )
            pos += 1
    while pos < len(slots):
        if slots[pos][0] != "bn":
            raise ValueError(f"unbound conv slot {slots[pos][1]}")
        fill_identity_bn(slots[pos])
        pos += 1
    # dense BN is affine=False in the module; exported scale/bias are the
    # synthesized ones/zeros, keeping them is equivalent.
    return params


def campplus_from_onnx(
    path: str, cfg: CampPlusConfig = CampPlusConfig()
) -> dict:
    from jyutvoice_tpu_torch.weights.onnx_reader import read_onnx

    graph = read_onnx(path)
    flat = graph.initializers
    try:
        return campplus_from_flat(flat, cfg)
    except KeyError:
        return campplus_from_onnx_graph(graph.nodes, flat, cfg)
