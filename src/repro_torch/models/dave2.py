"""DAVE-2 CNN (DeepPicar) — the paper's real-time control workload.

Counterpart of ``repro.models.dave2``: 5 VALID convs each followed by tanh,
3 fc layers with tanh, then the linear steering output; NHWC images
(B, 66, 200, 3) in, steering angles (B, 1) out (Bojarski et al. 2016, as
used by DeepPicar and RT-Gang §II/§V-C). The convolutions and fc products
are ``F.conv2d`` and ``torch.addmm``: the JAX package computes them outside
any Pallas kernel, so no kernel of this repo lies on this path.

Parameters are a flat dict under the keys of :func:`dave2_defs`
(``conv{i}_w``, ``conv{i}_b``, ``fc{i}_w``, ``fc{i}_b``). The defs carry
JAX's shapes (conv weights HWIO, fc weights (in, out)). The port holds
each conv weight as torch's contiguous OIHW (:func:`conv_weight`) and
convolves NCHW maps: the images are copied to NCHW once on entry, and the
last map back to JAX's (h, w, c) order before ``fc0``. (Kept NHWC,
cuDNN's f32 convolutions on the H100 are NCHW kernels with layout
conversions around each: more launches and more device time.) The fc
weights keep the ``x @ W`` orientation.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs.deeppicar import CONFIG, Dave2Config
from repro_torch.device import resolve_device
from repro_torch.models import layers as L


def dave2_defs(cfg: Dave2Config) -> Dict[str, L.ParamDef]:
    """The JAX package's definitions: the same keys, shapes and inits."""
    defs: Dict[str, L.ParamDef] = {}
    h, w = cfg.input_hw
    c_in = cfg.in_channels
    for i, (c_out, k, s) in enumerate(cfg.conv):
        defs[f"conv{i}_w"] = L.ParamDef((k, k, c_in, c_out),
                                        (None, None, None, None))
        defs[f"conv{i}_b"] = L.ParamDef((c_out,), (None,), "zeros")
        h = (h - k) // s + 1
        w = (w - k) // s + 1
        c_in = c_out
    flat = h * w * c_in
    dims = (flat,) + cfg.fc + (cfg.n_outputs,)
    for i in range(len(dims) - 1):
        defs[f"fc{i}_w"] = L.ParamDef((dims[i], dims[i + 1]), (None, None))
        defs[f"fc{i}_b"] = L.ParamDef((dims[i + 1],), (None,), "zeros")
    return defs


def conv_weight(w_hwio: torch.Tensor) -> torch.Tensor:
    """An HWIO conv weight as the port holds it: contiguous OIHW."""
    return w_hwio.permute(3, 2, 0, 1).contiguous()


def dave2_features(cfg: Dave2Config, params: Mapping[str, torch.Tensor],
                   images: torch.Tensor) -> torch.Tensor:
    """The flattened feature map that ``fc0`` reads, (B, h·w·c), in JAX's
    (h, w, c) order."""
    x = images.permute(0, 3, 1, 2).contiguous()
    for i, (_, _, s) in enumerate(cfg.conv):
        x = torch.tanh(F.conv2d(x, params[f"conv{i}_w"],
                                params[f"conv{i}_b"], stride=s))
    # JAX flattens the NHWC map; an NCHW flatten would misalign fc0's rows
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


def dave2_apply(cfg: Dave2Config, params: Mapping[str, torch.Tensor],
                images: torch.Tensor) -> torch.Tensor:
    """images: (B, H, W, 3) -> steering angle (B, 1)."""
    x = dave2_features(cfg, params, images)
    n_fc = len(cfg.fc) + 1
    for i in range(n_fc):
        x = torch.addmm(params[f"fc{i}_b"], x, params[f"fc{i}_w"])
        if i < n_fc - 1:
            x = torch.tanh(x)
    return x


class Dave2(nn.Module):
    """DAVE-2 over a flat parameter dict in the port's layout; the module
    shares the dict's tensors, and ``.to(device)`` moves a copy."""

    def __init__(self, cfg: Dave2Config, params: Mapping[str, torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.params = nn.ParameterDict({
            k: nn.Parameter(v, requires_grad=False)
            for k, v in params.items()})

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        return dave2_apply(self.cfg, self.params, images)


def make_dave2(cfg: Dave2Config = CONFIG,
               device: Optional[str | torch.device] = None,
               generator: Optional[torch.Generator] = None):
    """``(params, model)`` on ``device`` (default ``cuda``), f32. Each leaf
    is drawn by JAX's rule (normal x 1/sqrt(shape[-2]) of the JAX shape,
    biases zero) from ``generator`` (default: seed 0 on ``device``); the
    values are not JAX's, whose generator differs."""
    dev = resolve_device(device)
    gen = generator if generator is not None else \
        torch.Generator(device=dev).manual_seed(0)
    params = {}
    for k, d in dave2_defs(cfg).items():
        v = L._init_one(gen, d, torch.float32, dev)
        params[k] = conv_weight(v) if v.dim() == 4 else v
    return params, Dave2(cfg, params)
