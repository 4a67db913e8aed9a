"""Weight-only int8 quantization for serving (port of oatx/serve/quant.py).

Post-training, symmetric, per-output-channel int8 of the matmul weights:
w ≈ q · scale with q in [-127, 127], scale = max(amax, finfo(f32).tiny) / 127
from the f32 amax over the contraction axes, q = rint(w / scale) (half to
even) clipped to ±127. Training keeps its f32 master weights; this is the
serving path only (EmbedService(quantize="int8"), cli.serve --quantize,
cli.export_serving --quantize).

Which weights: oatx quantizes each leaf of its parameter tree named
`kernel` with 2-4 dimensions and at least `min_elems` elements. The port's
parameters are mapped to those leaves (`parallel.sharding.oatx_leaf`), so
a depth-stacked block's weight counts its whole (depth, in, out) leaf: a
depth-2 tower's 32 × 64 fc1 weight has 2048 elements, but its leaf has 4096.
oatx's kernels are the Linear weights (biases, LN scales, embedding tables,
positional tables, cls tokens and CLIP's text_projection are not), the
patch-embedding conv and CLIP text's packed `in_proj_weight`. The scales are
the same numbers as oatx's: a Linear (out, in) reduces `in` per output row,
which is oatx's (L, in, out) over `in`, layer by layer; a conv (O, I, kh, kw)
reduces (I, kh, kw), which is oatx's HWIO over (H, W, I).

`quantize_model` replaces each such parameter, under its own name, by two
buffers on the same device (`<name>_q8` int8 and `<name>_q8_scale` f32),
and its module class gains a property of that name that returns
`q.float() * scale` at each access: the weight is dequantized where it is
used, and then cast by the layer as the f32 weight would be (the kernels'
wrappers cast it to bf16), as oatx's `dequantize_tree(p, float32)` runs
inside the jitted graph. No dequantized copy stays resident, and
torch.export keeps the int8 buffers as the program's state with the
dequantize in its graph.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import torch
from torch import nn

from oatx_torch.parallel.sharding import _STACKED, _TABLES, _depths, oatx_leaf

Q_SUFFIX, SCALE_SUFFIX = "_q8", "_q8_scale"


def _contraction_axes(ndim: int) -> Tuple[int, ...]:
    """Axes reduced for the per-output-channel scale, in torch layouts:
    a Linear (out, in) reduces in; a conv (O, I, kh, kw) reduces I, kh, kw."""
    if ndim == 2:
        return (1,)
    if ndim == 4:
        return (1, 2, 3)
    raise ValueError(f"unsupported weight rank {ndim}")


def quantize_array(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int8 of one torch-layout weight, on its
    device: (q int8, scale f32 with w's rank), w ≈ q * scale."""
    w = w.detach().float()
    amax = w.abs().amax(dim=_contraction_axes(w.ndim), keepdim=True)
    scale = torch.clamp_min(amax, torch.finfo(torch.float32).tiny) / 127.0
    q = torch.round(w / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale


def is_oatx_kernel(name: str, shape) -> bool:
    """Whether the port's parameter `name` comes from a leaf that oatx names
    `kernel` (models/convert.py: `_dense`, the patch embedding, CLIP's qkv)."""
    parts = name.split(".")
    leaf, parent = parts[-1], (parts[-2] if len(parts) > 1 else "")
    if leaf == "in_proj_weight":
        return True
    return leaf == "weight" and (len(shape) == 4 or (len(shape) == 2 and parent not in _TABLES))


def leaf_key(name: str) -> str:
    """One key per oatx leaf: a stacked layer's index becomes '*'."""
    m = _STACKED.match(name)
    return f"{m.group(1)}.*.{m.group(3)}" if m else name


def eligible(named_shapes: Dict[str, Tuple[int, ...]], min_elems: int = 4096) -> list:
    """The parameter names that oatx's `quantize_tree` would quantize."""
    depths = _depths(named_shapes)
    out = []
    for name, shape in named_shapes.items():
        if not is_oatx_kernel(name, shape):
            continue
        dims, _ = oatx_leaf(name, shape, depths)
        if 2 <= len(dims) <= 4 and math.prod(dims) >= min_elems:
            out.append(name)
    return out


def _dequantized(module: nn.Module, name: str) -> torch.Tensor:
    b = module._buffers
    return b[name + Q_SUFFIX].float() * b[name + SCALE_SUFFIX]


_CLASSES: Dict[Tuple[type, frozenset], type] = {}


def _dequantizing_class(cls: type, names: Iterable[str]) -> type:
    """`cls` with a property per quantized weight name (module docstring)."""
    key = (cls, frozenset(names))
    if key not in _CLASSES:
        props = {n: property(lambda self, n=n: _dequantized(self, n)) for n in key[1]}
        _CLASSES[key] = type(cls.__name__, (cls,), props)
    return _CLASSES[key]


def quantize_model(model: nn.Module, *, min_elems: int = 4096) -> Dict[str, object]:
    """Quantize `model`'s eligible weights in place (module docstring) and
    return `quantization_report(model)`. Raises when nothing is eligible, as
    oatx's quantize_tree does."""
    params = dict(model.named_parameters())
    names = eligible({n: tuple(p.shape) for n, p in params.items()
                      if p.is_floating_point()}, min_elems)
    if not names:
        raise ValueError(f"quantize_model: no kernel >= {min_elems} elements found — "
                         "wrong model or min_elems too high")
    by_module: Dict[nn.Module, list] = {}
    with torch.no_grad():
        for name in names:
            path, _, leaf = name.rpartition(".")
            module = model.get_submodule(path) if path else model
            p = params[name]
            q, scale = quantize_array(p)
            del module._parameters[leaf]
            module.register_buffer(leaf + Q_SUFFIX, q)
            module.register_buffer(leaf + SCALE_SUFFIX, scale)
            # the element size of the weight it replaced, for the report
            module.__dict__.setdefault("_q8_itemsize", {})[leaf] = p.element_size()
            by_module.setdefault(module, []).append(leaf)
    for module, leaves in by_module.items():
        module.__class__ = _dequantizing_class(type(module), leaves)
    return quantization_report(model)


def quantization_report(model: nn.Module) -> Dict[str, object]:
    """oatx's byte accounting (`quantization_report`) of a quantized model:
    the oatx leaves quantized (a stacked depth counts once), the bytes of
    the parameters before and after."""
    rest = sum(p.nbytes for p in model.parameters())
    full = quantized = rest
    leaves = set()
    for mn, m in model.named_modules():
        for leaf, itemsize in m.__dict__.get("_q8_itemsize", {}).items():
            q, scale = m._buffers[leaf + Q_SUFFIX], m._buffers[leaf + SCALE_SUFFIX]
            full += q.numel() * itemsize
            quantized += q.nbytes + scale.nbytes
            leaves.add(leaf_key(f"{mn}.{leaf}" if mn else leaf))
    return {"mode": "int8", "quantized_kernels": len(leaves),
            "bytes_full": int(full), "bytes_quantized": int(quantized)}
