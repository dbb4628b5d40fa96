"""Carry weights from the JAX package's Llama, BERT, GPT and vision models
(every family of vision/models), its fused layers, its quantized models,
its MoE layer and gates and sparse.nn's BatchNorm and 3-D convolutions, to
the port's.

Parameter names and layouts are the same in both packages, so a reference
state dict, as numpy arrays, maps onto the port key for key:

    np_state = {k: np.asarray(v._data) for k, v in jax_model.state_dict().items()}
    load_reference_state(port_model, np_state)

The vision models' states hold their batch norms' running statistics
(`_mean`, `_variance`) beside the parameters. `load_reference_state` takes
any model whose keys are the reference's: also incubate.nn's fused layers
(their parameters by the reference's names) and models that
quantization.QAT or PTQ wrapped, whose states hold each observer's and
quanter's float32 `_scale` buffer (`fc1.weight_quanter._observer._scale`,
`fc1.act_observer._scale`, ...) beside the wrapped layers' parameters
(`fc1._inner.weight`), so that a calibrated reference model and its port
quantize at the same scales. Both functions raise on a
missing or an unexpected key and on a shape mismatch. `tree_from_reference` carries a nested dict of arrays across as
it is: the scanned params tree of `build_scanned_llama`, its grads, or an
optimizer-state tree of `Optimizer.tree_init`.

`state_from_reference` tells a state's family by a key only that family's
states hold (or, for the `features.0.weight` families, by the stem: LeNet
has one input channel, AlexNet an 11 x 11 kernel, SqueezeNet fire modules,
VGG none of these). ResNet's, VGG's and LeNet's maps are written out
below. Each other family's map is the port's own model of the
configuration the state shows (its class count, depth or scale), built on
the meta device: no memory, no draw. Where the state does not show its
configuration outright (a MobileNet's or ShuffleNet's scale, DenseNet's
depth), the candidate configurations are built in turn and the first the
state fits is taken, or else the closest one, so that the check names the
missing, unexpected or misshapen keys. A MobileNet's scale is one of
MOBILENET_SCALES, or for V1 the one its last block's width shows. A
MoELayer's state is its gate (`gate.gate.weight`/`bias`) and its experts
(`experts.i.*`, each with expert 0's keys and shapes); a gate's alone is
`gate.weight`/`bias`; sparse.nn's BatchNorm keeps the dense one as `_bn`
and its Conv3D and SubmConv3D the dense NDHWC convolution as `_conv`
(weight (out, in, kd, kh, kw)). ASP masks are not carried: they are
rebuilt from a pruned model's weights.

`moe_params_from_reference` carries parallel.moe.ExpertParallelMoE's
`init` dict (gate, w1, w2); `load_reference_pipe` fills a
LlamaPipeRunner's embedding, stacked stage and head tensors from a
reference Llama's state dict; `load_reference_table` loads a PS table the
reference saved (its native checkpoint, or its numpy store's .npz).
"""

from __future__ import annotations

import re

import numpy as np
import torch

from .framework.device import resolve_device
from .framework.dtypes import convert_dtype
from .vision import models as _vision
from .vision.models.vgg import _CFGS as _VGG_CFGS

__all__ = ["state_from_reference", "load_reference_state",
           "tree_from_reference", "tensor_from_bytes",
           "load_reference_program", "moe_params_from_reference",
           "load_reference_pipe", "load_reference_table"]

# the scales tried on a MobileNet state (the published ones of V1-V3 and
# the reference's tests')
MOBILENET_SCALES = (0.25, 0.35, 0.5, 0.75, 1.0, 1.25, 1.4, 1.5, 2.0)


def _shape(np_state, key):
    try:
        return tuple(np.shape(np_state[key]))
    except KeyError:
        raise KeyError(f"reference state lacks {key!r}") from None


def _depth(np_state, layers: str) -> int:
    """1 + the largest index i of a key `{layers}.{i}.*`."""
    rx = re.compile(re.escape(layers) + r"\.(\d+)\.")
    return 1 + max((int(m.group(1)) for m in map(rx.match, np_state) if m),
                   default=-1)


def _stacked(prefix: str, depth: int, layer: dict) -> dict:
    return {f"{prefix}.{i}.{k}": s for i in range(depth)
            for k, s in layer.items()}


def _llama_shapes(np_state) -> dict:
    """The key -> shape map of a complete Llama state with the vocabulary,
    widths and depth that `np_state` itself shows."""
    vocab, hidden = _shape(np_state, "llama.embed_tokens.weight")
    ffn = _shape(np_state, "llama.layers.0.mlp.gate_proj.weight")[1]
    kv = _shape(np_state, "llama.layers.0.self_attn.k_proj.weight")[1]
    layer = {"self_attn.q_proj.weight": (hidden, hidden),
             "self_attn.k_proj.weight": (hidden, kv),
             "self_attn.v_proj.weight": (hidden, kv),
             "self_attn.o_proj.weight": (hidden, hidden),
             "mlp.gate_proj.weight": (hidden, ffn),
             "mlp.up_proj.weight": (hidden, ffn),
             "mlp.down_proj.weight": (ffn, hidden),
             "input_layernorm.weight": (hidden,),
             "post_attention_layernorm.weight": (hidden,)}
    shapes = {"llama.embed_tokens.weight": (vocab, hidden),
              "llama.norm.weight": (hidden,)}
    shapes.update(_stacked("llama.layers", _depth(np_state, "llama.layers"),
                           layer))
    if "lm_head.weight" in np_state:   # absent when embeddings are tied
        shapes["lm_head.weight"] = (hidden, vocab)
    return shapes


def _linear(name, n_in, n_out):
    return {f"{name}.weight": (n_in, n_out), f"{name}.bias": (n_out,)}


def _norm(name, n):
    return {f"{name}.weight": (n,), f"{name}.bias": (n,)}


def _bert_shapes(np_state) -> dict:
    """A complete BertForPretraining or BertForSequenceClassification
    state (models/bert.py); which one, and its widths, depth and class
    count, as `np_state` shows them."""
    vocab, h = _shape(np_state, "bert.embeddings.word_embeddings.weight")
    ffn = _shape(np_state, "bert.encoder.0.ffn1.weight")[1]
    e = "bert.embeddings."
    shapes = {e + "word_embeddings.weight": (vocab, h),
              e + "position_embeddings.weight":
                  (_shape(np_state, e + "position_embeddings.weight")[0], h),
              e + "token_type_embeddings.weight":
                  (_shape(np_state, e + "token_type_embeddings.weight")[0],
                   h),
              **_norm(e + "layer_norm", h), **_linear("bert.pooler", h, h)}
    layer = {**_linear("q", h, h), **_linear("k", h, h),
             **_linear("v", h, h), **_linear("attn_out", h, h),
             **_norm("attn_norm", h), **_linear("ffn1", h, ffn),
             **_linear("ffn2", ffn, h), **_norm("ffn_norm", h)}
    shapes.update(_stacked("bert.encoder", _depth(np_state, "bert.encoder"),
                           layer))
    if "classifier.weight" in np_state:
        n = _shape(np_state, "classifier.weight")[1]
        shapes.update(_linear("classifier", h, n))
    else:
        shapes.update({**_linear("mlm_transform", h, h),
                       **_norm("mlm_norm", h), **_linear("nsp_head", h, 2)})
    return shapes


def _gpt_shapes(np_state) -> dict:
    """A complete GPTForCausalLM state (models/gpt.py), tied or not, with
    the widths and depth `np_state` shows."""
    vocab, h = _shape(np_state, "gpt.wte.weight")
    ffn = _shape(np_state, "gpt.h.0.fc1.weight")[1]
    shapes = {"gpt.wte.weight": (vocab, h),
              "gpt.wpe.weight": (_shape(np_state, "gpt.wpe.weight")[0], h),
              **_norm("gpt.ln_f", h)}
    layer = {**_norm("ln_1", h), **_linear("attn.qkv_proj", h, 3 * h),
             **_linear("attn.out_proj", h, h), **_norm("ln_2", h),
             **_linear("fc1", h, ffn), **_linear("fc2", ffn, h)}
    shapes.update(_stacked("gpt.h", _depth(np_state, "gpt.h"), layer))
    if "lm_head.weight" in np_state:   # absent when embeddings are tied
        shapes["lm_head.weight"] = (h, vocab)
    return shapes


def _bn(name, n):
    return {f"{name}.{k}": (n,) for k in ("weight", "bias", "_mean",
                                           "_variance")}


def _conv(name, c_out, c_in, k, bias=False):
    out = {f"{name}.weight": (c_out, c_in, k, k)}
    if bias:
        out[f"{name}.bias"] = (c_out,)
    return out


def _resnet_shapes(np_state) -> dict:
    """A complete ResNet state (vision/models/resnet.py): basic or
    bottleneck blocks, the blocks per stage, groups, width and class count
    as `np_state` shows them."""
    bottleneck = "layer1.0.conv3.weight" in np_state
    expansion = 4 if bottleneck else 1
    if bottleneck:
        width, per_group = _shape(np_state, "layer1.0.conv2.weight")[:2]
        groups = width // per_group
        base_width = per_group       # stage 1's planes are 64
    shapes = {**_conv("conv1", 64, 3, 7), **_bn("bn1", 64)}
    inplanes = 64
    for i, planes in enumerate((64, 128, 256, 512), 1):
        out = planes * expansion
        for j in range(_depth(np_state, f"layer{i}")):
            p = f"layer{i}.{j}."
            if bottleneck:
                w = int(planes * (base_width / 64.0)) * groups
                block = {**_conv("conv1", w, inplanes, 1), **_bn("bn1", w),
                         **_conv("conv2", w, w // groups, 3),
                         **_bn("bn2", w), **_conv("conv3", out, w, 1),
                         **_bn("bn3", out)}
            else:
                block = {**_conv("conv1", planes, inplanes, 3),
                         **_bn("bn1", planes),
                         **_conv("conv2", planes, planes, 3),
                         **_bn("bn2", planes)}
            if j == 0 and (i > 1 or inplanes != out):
                block.update({**_conv("downsample.0", out, inplanes, 1),
                              **_bn("downsample.1", out)})
            shapes.update({p + k: v for k, v in block.items()})
            inplanes = out
    if "fc.weight" in np_state:
        shapes.update(_linear("fc", inplanes,
                              _shape(np_state, "fc.weight")[1]))
    return shapes


def _vgg_shapes(np_state) -> dict:
    """A complete VGG state (vision/models/vgg.py): the configuration by its
    number of convolutions, with or without batch norm, and the class
    count, as `np_state` shows them."""
    n_conv = sum(1 for k in np_state
                 if re.fullmatch(r"features\.\d+\.weight", k)
                 and len(np.shape(np_state[k])) == 4)
    cfg = next((c for c in _VGG_CFGS.values()
                if sum(v != "M" for v in c) == n_conv), None)
    if cfg is None:
        raise KeyError(f"a VGG state with {n_conv} convolutions is of no "
                       f"known configuration")
    bn = any(k.endswith("._mean") for k in np_state)
    shapes, i, in_c = {}, 0, 3
    for v in cfg:
        if v != "M":
            shapes.update(_conv(f"features.{i}", v, in_c, 3, bias=True))
            if bn:
                i += 1
                shapes.update(_bn(f"features.{i}", v))
            i += 1              # the ReLU
            in_c = v
        i += 1
    if "classifier.6.weight" in np_state:
        shapes.update({**_linear("classifier.0", 512 * 7 * 7, 4096),
                       **_linear("classifier.3", 4096, 4096),
                       **_linear("classifier.6", 4096, _shape(
                           np_state, "classifier.6.weight")[1])})
    return shapes


def _lenet_shapes(np_state) -> dict:
    """A complete LeNet state (vision/models/lenet.py) with the class count
    `np_state` shows."""
    shapes = {**_conv("features.0", 6, 1, 3, bias=True),
              **_conv("features.3", 16, 6, 5, bias=True)}
    if "fc.2.weight" in np_state:
        shapes.update({**_linear("fc.0", 400, 120),
                       **_linear("fc.1", 120, 84),
                       **_linear("fc.2", 84,
                                 _shape(np_state, "fc.2.weight")[1])})
    return shapes


def _built(ctor, **kw) -> dict:
    """key -> shape of the port's `ctor(**kw)`, built on the meta device."""
    return {k: tuple(v.shape)
            for k, v in ctor(device="meta", **kw).state_dict().items()}


def _classes(np_state, key, axis=1) -> int:
    """The class count: dim `axis` of the head's `key`, 0 without a head."""
    return _shape(np_state, key)[axis] if key in np_state else 0


def _faults(np_state, shapes) -> int:
    return len(set(shapes) ^ set(np_state)) + sum(
        tuple(np.shape(np_state[k])) != s for k, s in shapes.items()
        if k in np_state)


def _closest(np_state, candidates) -> dict:
    """The first candidate map `np_state` fits, else the one it misses by
    the fewest keys and shapes."""
    best = None
    for shapes in candidates:
        n = _faults(np_state, shapes)
        if n == 0:
            return shapes
        if best is None or n < best[0]:
            best = (n, shapes)
    return best[1]


def _alexnet_shapes(np_state) -> dict:
    return _built(_vision.AlexNet,
                  num_classes=_classes(np_state, "classifier.6.weight"))


def _squeezenet_shapes(np_state) -> dict:
    """Version 1.0 (a 7 x 7 stem) or 1.1 (3 x 3)."""
    version = "1.0" if _shape(np_state, "features.0.weight")[-1] == 7 \
        else "1.1"
    return _built(_vision.SqueezeNet, version=version, num_classes=_classes(
        np_state, "final_conv.weight", 0))


def _features_shapes(np_state) -> dict:
    """LeNet (one input channel), AlexNet (an 11 x 11 stem), SqueezeNet
    (fire modules) or VGG."""
    stem = _shape(np_state, "features.0.weight")
    if stem[1] == 1:
        return _lenet_shapes(np_state)
    if any(".squeeze." in k for k in np_state):
        return _squeezenet_shapes(np_state)
    if stem[-1] == 11:
        return _alexnet_shapes(np_state)
    return _vgg_shapes(np_state)


def _mobilenet_v1_shapes(np_state) -> dict:
    classes = _classes(np_state, "fc.weight")
    width = np_state.get("blocks.12.pw.conv.weight")
    scales = MOBILENET_SCALES if width is None else \
        (np.shape(width)[0] / 1024,) + MOBILENET_SCALES
    return _closest(np_state, (_built(_vision.MobileNetV1, scale=s,
                                      num_classes=classes) for s in scales))


def _mobilenet_v2_shapes(np_state) -> dict:
    classes = _classes(np_state, "classifier.1.weight")
    return _closest(np_state, (_built(_vision.MobileNetV2, scale=s,
                                      num_classes=classes)
                               for s in MOBILENET_SCALES))


def _mobilenet_v3_shapes(np_state) -> dict:
    """Small or Large at one of MOBILENET_SCALES."""
    classes = _classes(np_state, "classifier.3.weight")
    return _closest(np_state, (_built(ctor, scale=s, num_classes=classes)
                               for ctor in (_vision.MobileNetV3Small,
                                            _vision.MobileNetV3Large)
                               for s in MOBILENET_SCALES))


def _densenet_shapes(np_state) -> dict:
    """Depth 121-264; bn_size from the first 1 x 1 convolution."""
    from .vision.models.densenet import _ARCH
    classes = _classes(np_state, "fc.weight")
    width = _shape(np_state, "blocks.0.layers.0.conv1.weight")[0]
    return _closest(np_state, (_built(_vision.DenseNet, layers=n,
                                      bn_size=width // growth,
                                      num_classes=classes)
                               for n, (growth, _, _) in _ARCH.items()))


def _shufflenet_shapes(np_state) -> dict:
    classes = _classes(np_state, "fc.weight")
    return _closest(np_state, (_built(_vision.ShuffleNetV2, scale=s,
                                      num_classes=classes)
                               for s in _vision.ShuffleNetV2._STAGE_OUT))


def _googlenet_shapes(np_state) -> dict:
    return _built(_vision.GoogLeNet,
                  num_classes=_classes(np_state, "fc.weight"))


def _inception_v3_shapes(np_state) -> dict:
    return _built(_vision.InceptionV3,
                  num_classes=_classes(np_state, "fc.weight"))


def _moe_shapes(np_state) -> dict:
    """An incubate MoELayer: its gate (`gate.gate`, a Linear(d_model, E))
    and E experts, each holding expert 0's keys and shapes."""
    d, e = _shape(np_state, "gate.gate.weight")
    shapes = {"gate.gate.weight": (d, e), "gate.gate.bias": (e,)}
    first = {k[len("experts.0."):]: _shape(np_state, k) for k in np_state
             if k.startswith("experts.0.")}
    for i in range(e):
        shapes.update({f"experts.{i}.{k}": s for k, s in first.items()})
    return shapes


def _gate_shapes(np_state) -> dict:
    """A MoE gate alone (Naive, GShard or Switch): a Linear(d_model, E)."""
    from .incubate.distributed.models.moe import NaiveGate
    d, e = _shape(np_state, "gate.weight")
    return _built(NaiveGate, d_model=d, num_expert=e)


def _sparse_bn_shapes(np_state) -> dict:
    """sparse.nn.BatchNorm: the dense BatchNorm1D as `_bn`."""
    from .sparse.nn import BatchNorm
    return _built(BatchNorm, num_features=_shape(np_state, "_bn._mean")[0])


def _sparse_conv_shapes(np_state) -> dict:
    """sparse.nn.Conv3D or SubmConv3D: the dense convolution as `_conv`
    (weight (out, in, kd, kh, kw), the bias if the state has one)."""
    from .sparse.nn import SubmConv3D
    w = _shape(np_state, "_conv.weight")
    if len(w) != 5:
        raise ValueError(f"_conv.weight: reference shape {w} is no 3-D "
                         "convolution's")
    return _built(SubmConv3D, in_channels=w[1], out_channels=w[0],
                  kernel_size=w[2:],
                  bias_attr=None if "_conv.bias" in np_state else False)


# each family by the key prefix of its models' states; the vision models'
# keys have no prefix, so each of those by a key only its states hold
_FAMILIES = {"llama.": _llama_shapes, "bert.": _bert_shapes,
             "gpt.": _gpt_shapes}
_KEYED = {"layer1.0.conv1.weight": _resnet_shapes,
          "features.0.weight": _features_shapes,
          "blocks.0.dw.conv.weight": _mobilenet_v1_shapes,
          "features.1.conv.0.conv.weight": _mobilenet_v2_shapes,
          "features.1.block.0.conv.weight": _mobilenet_v3_shapes,
          "blocks.0.layers.0.conv1.weight": _densenet_shapes,
          "stages.0.0.branch1.0.weight": _shufflenet_shapes,
          "i3a.b1.conv.weight": _googlenet_shapes,
          "blocks.0.b1.conv.weight": _inception_v3_shapes,
          "gate.gate.weight": _moe_shapes, "gate.weight": _gate_shapes,
          "_bn._mean": _sparse_bn_shapes,
          "_conv.weight": _sparse_conv_shapes}


def _reference_shapes(np_state) -> dict:
    """The key -> shape map of the model family `np_state` belongs to."""
    for prefix, shapes in _FAMILIES.items():
        if any(k.startswith(prefix) for k in np_state):
            return shapes(np_state)
    for key, shapes in _KEYED.items():
        if key in np_state:
            return shapes(np_state)
    raise KeyError(f"reference state of no known family (keys starting "
                   f"{sorted(_FAMILIES)}, or holding {sorted(_KEYED)})")


def _check(np_state, shapes: dict) -> None:
    missing = sorted(set(shapes) - set(np_state))
    unexpected = sorted(set(np_state) - set(shapes))
    if missing or unexpected:
        raise KeyError(f"state keys differ: missing {missing}, unexpected "
                       f"{unexpected}")
    for k, shape in shapes.items():
        if tuple(np.shape(np_state[k])) != tuple(shape):
            raise ValueError(f"{k}: reference shape "
                             f"{tuple(np.shape(np_state[k]))} != {tuple(shape)}")


def tensor_from_bytes(raw, dtype_name, shape) -> torch.Tensor:
    """A CPU tensor of torch dtype `dtype_name` ("bfloat16",
    "float8_e4m3fn", "float8_e5m2", ...) and `shape` from its raw bytes:
    how the port reads dtypes numpy has no type for, without ml_dtypes."""
    dtype = getattr(torch, dtype_name)
    flat = np.ascontiguousarray(raw).reshape(-1).view(np.uint8)
    if not flat.size:
        return torch.empty(tuple(shape), dtype=dtype)
    return torch.from_numpy(flat.copy()).view(dtype).reshape(tuple(shape))


def _tensor(a) -> torch.Tensor:
    """A torch copy of an array (JAX hands out read-only arrays)."""
    a = np.asarray(a)
    if a.dtype.kind == "V":   # ml_dtypes' bf16/fp8, which torch can't read
        return tensor_from_bytes(a, a.dtype.name, a.shape)
    return torch.tensor(a)


def state_from_reference(np_state: dict, device, dtype=None) -> dict:
    """The port's state dict of a Llama, BERT, GPT or vision model (torch
    tensors on `device`, in `dtype` or the arrays' own dtype) from a
    reference state of numpy arrays."""
    _check(np_state, _reference_shapes(np_state))
    device = resolve_device(device)
    dt = None if dtype is None else convert_dtype(dtype)
    return {k: _tensor(v).to(device=device, dtype=dt)
            for k, v in np_state.items()}


@torch.no_grad()
def load_reference_state(model: torch.nn.Module, np_state: dict) -> None:
    """Copy a reference state of numpy arrays into `model` in place, each
    array cast to its parameter's dtype and device."""
    params = model.state_dict()
    _check(np_state, {k: tuple(v.shape) for k, v in params.items()})
    for k, p in params.items():
        p.copy_(_tensor(np_state[k]))


@torch.no_grad()
def load_reference_program(program, np_state: dict) -> None:
    """Copy a reference `static.Program`'s registry (its `state_dict()` as
    numpy arrays) into the port's `static.Program` by name, in place, each
    array cast to its tensor's dtype and device. The two registries must
    hold the same names and shapes: `static.nn` names parameters as the
    reference does, so building both programs under a fresh
    `unique_name.guard()` makes them so."""
    params = program.state_dict()
    _check(np_state, {k: tuple(v.shape) for k, v in params.items()})
    for k, p in params.items():
        p.copy_(_tensor(np_state[k]))


def tree_from_reference(np_tree, device, dtype=None):
    """A nested dict of numpy arrays -> the same nested dict of torch tensors
    on `device`, in `dtype` or each array's own dtype."""
    device = resolve_device(device)
    dt = None if dtype is None else convert_dtype(dtype)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        return _tensor(x).to(device=device, dtype=dt)
    return conv(np_tree)


def moe_params_from_reference(np_params: dict, device, dtype=None,
                              mesh=None, axis_name="ep") -> dict:
    """ExpertParallelMoE's params (gate [D, E], w1 [E, D, H], w2 [E, H, D])
    from the reference's `init` dict as numpy arrays, w1 and w2 marked
    Shard(0) on `axis_name` where `mesh` has it. Raises on a missing or
    unexpected key or inconsistent shapes."""
    if set(np_params) != {"gate", "w1", "w2"}:
        raise KeyError(f"an ExpertParallelMoE init dict holds gate, w1 and "
                       f"w2, not {sorted(np_params)}")
    d, e = np.shape(np_params["gate"])
    h = np.shape(np_params["w1"])[2]
    want = {"gate": (d, e), "w1": (e, d, h), "w2": (e, h, d)}
    for k, shape in want.items():
        if tuple(np.shape(np_params[k])) != shape:
            raise ValueError(f"{k}: shape {np.shape(np_params[k])}, the "
                             f"gate's widths give {shape}")
    out = tree_from_reference(np_params, device, dtype)
    if mesh is not None and axis_name in mesh.dim_names:
        from .distributed.placement import P, spec_to_placements
        for k in ("w1", "w2"):
            out[k].process_mesh = mesh
            out[k].placements = spec_to_placements(P(axis_name), mesh, 3)
    return out


@torch.no_grad()
def load_reference_pipe(runner, np_state: dict) -> None:
    """Copy a reference LlamaForCausalLM's state dict (numpy arrays) into
    `runner`'s (a LlamaPipeRunner's) embed, stacked stage and head tensors,
    laid out as the runner stacks its own model's; raises on a missing or
    unexpected key or a shape mismatch."""
    from .parallel.functional import split_stacked_layer_params
    state = {k: _tensor(v) for k, v in np_state.items()}
    stacked, other = split_stacked_layer_params(state)
    names = {"llama.embed_tokens.weight": runner.embed_params["weight"],
             "llama.norm.weight": runner.head_params["norm"]}
    if "lm_head" in runner.head_params:
        names["lm_head.weight"] = runner.head_params["lm_head"]
    if set(other) != set(names) or set(stacked) != set(runner.stage_params):
        raise KeyError(f"reference keys {sorted(other)} + layers "
                       f"{sorted(stacked)} do not match the runner's")
    lead = 3 if runner.schedule == "VPP" else 2
    pairs = [(k, other[k], t) for k, t in names.items()] + [
        (k, arr, runner.stage_params[k]) for k, arr in stacked.items()]
    for k, src, dst in pairs:
        inner = dst.shape[lead:] if k in stacked else dst.shape
        if tuple(src.shape[-len(inner):] if inner else ()) != tuple(inner) \
                or src.numel() != dst.numel():
            raise ValueError(f"{k}: shape {tuple(src.shape)} against the "
                             f"runner's {tuple(dst.shape)}")
        if k in stacked and runner.schedule == "VPP":
            pp, v, lv = dst.shape[:3]
            src = src.reshape((v, pp, lv) + src.shape[1:]).transpose(0, 1)
        dst.copy_(src.reshape(dst.shape))


def load_reference_table(table, path: str) -> None:
    """Load a SparseTable the reference saved at `path` into `table` (a
    port SparseTable of the same emb_dim and rule): the native checkpoint
    (the 'PTPS' format both packages' csrc/ps_table.cc write) into either
    store, or the reference's numpy store's `path`.npz into a numpy-store
    table."""
    import os
    npz = path if path.endswith(".npz") else path + ".npz"
    if os.path.exists(path) and not path.endswith(".npz"):
        with open(path, "rb") as f:
            if f.read(4) != b"PTPS":
                raise ValueError(f"{path} is not a PS table checkpoint")
        if table._native:
            table.load(path)
            return
        raise ValueError(f"{path} is a native checkpoint: load it into a "
                         f"table with the native store")
    if table._native:
        raise ValueError(f"{npz} is the numpy store's: load it into a "
                         f"SparseTable(use_native=False)")
    table.load(npz)
