"""The paper's six served edge models (Table IV) as runnable networks: the
port of ``repro.models.cnn``.

Compact but architecturally faithful: residual basic blocks for ResNet-18,
SE inverted residuals for MobileNetV3 and EfficientNet-B0, parallel
inception branches for Inception-v3, a CSP-style backbone and detect head
for YOLOv5s, and a small BERT encoder for TinyBERT (the port's decoder
trunk, causal as in the reference, so its attention runs
``flash_attention`` at head dim 64). The serving simulator prices these
models with the analytic profiles of ``configs/paper_edge_models.py``;
these nets are the real-execution path.

Inputs and outputs keep the reference's NHWC layout ((B, H, W, C) images,
YOLO's (B, H', W', anchors * (5 + classes)) map); inside, the nets run
NCHW with ``torch.nn.functional.conv2d`` weights ``(C_out, C_in / groups,
kh, kw)``, the counterpart of the reference's ``lax.conv_general_dilated``
(HWIO weights, "SAME" padding: the extra row and column go after, as
here). The reference convolves outside any Pallas kernel, so there is no
hand-written kernel here. On the card cuDNN runs with TF32 off for the
duration of each forward. :func:`edge_params_from_jax` and
:func:`tinybert_params_from_jax` carry the reference's weights across.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.config.base import ModelConfig
from repro_torch.models.layers import dense_init


# ---------------------------------------------------------------- conv utils
@contextlib.contextmanager
def _fp32_convs():
    """cuDNN without TF32 (full fp32 products, as the matmuls run)."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def _nhwc_forward(fn):
    """Wrap a forward over NCHW tensors: an NHWC image in, TF32 off."""
    @functools.wraps(fn)
    def forward(p, x):
        with _fp32_convs():
            return fn(p, x.permute(0, 3, 1, 2))
    return forward


def _generator(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(seed)
    return gen


def conv_init(gen, kh, kw, cin, cout, device) -> torch.Tensor:
    """He-normal weights ``(cout, cin, kh, kw)`` (the reference's fan-in,
    kh * kw * cin)."""
    w = torch.randn((cout, cin, kh, kw), generator=gen, dtype=torch.float32,
                    device=device)
    return w * (2.0 / (kh * kw * cin)) ** 0.5


def _same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's "SAME" padding of one spatial axis: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x, kh, kw, stride, value=0.0):
    ph, pw = _same_pads(x.shape[2], kh, stride), \
        _same_pads(x.shape[3], kw, stride)
    if ph == (0, 0) and pw == (0, 0):
        return x
    return F.pad(x, (pw[0], pw[1], ph[0], ph[1]), value=value)


def conv(x, w, stride=1, groups=1):
    """NCHW x, "SAME" padding."""
    x = _pad_same(x, w.shape[2], w.shape[3], stride)
    return F.conv2d(x, w, stride=stride, groups=groups)


def _max_pool(x, k, stride):
    """The reference's ``reduce_window`` max with -inf "SAME" padding."""
    return F.max_pool2d(_pad_same(x, k, k, stride, value=float("-inf")), k,
                        stride)


def bn_init(c, device):
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}


def bn(p, x, eps=1e-5):
    """Normalise over batch and space (the reference serves these nets
    with batch statistics), population variance."""
    mu = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), keepdim=True, unbiased=False)
    return (x - mu) / torch.sqrt(var + eps) * p["scale"][:, None, None] \
        + p["bias"][:, None, None]


def _pool_head(x, head):
    return x.mean(dim=(2, 3)) @ head


# ---------------------------------------------------------------- ResNet-18
def resnet18_init(seed=0, n_classes=1000, width=16, device="cuda"):
    """width=64 is the true ResNet-18; smaller widths for smoke runs."""
    gen = _generator(seed, device)
    w = width
    p: Dict = {"stem": conv_init(gen, 7, 7, 3, w, device),
               "stem_bn": bn_init(w, device), "blocks": []}
    cin = w
    for cout, n_blocks in [(w, 2), (2 * w, 2), (4 * w, 2), (8 * w, 2)]:
        for b in range(n_blocks):
            stride = 2 if (b == 0 and cout != w) else 1
            blk = {"c1": conv_init(gen, 3, 3, cin, cout, device),
                   "bn1": bn_init(cout, device),
                   "c2": conv_init(gen, 3, 3, cout, cout, device),
                   "bn2": bn_init(cout, device), "stride": stride}
            if stride != 1 or cin != cout:
                blk["proj"] = conv_init(gen, 1, 1, cin, cout, device)
            p["blocks"].append(blk)
            cin = cout
    p["head"] = dense_init(gen, cin, n_classes, torch.float32, device)
    return p


@_nhwc_forward
def resnet18_apply(p, x):
    x = F.relu(bn(p["stem_bn"], conv(x, p["stem"], stride=2)))
    x = _max_pool(x, 3, 2)
    for blk in p["blocks"]:
        h = F.relu(bn(blk["bn1"], conv(x, blk["c1"], stride=blk["stride"])))
        h = bn(blk["bn2"], conv(h, blk["c2"]))
        sc = conv(x, blk["proj"], stride=blk["stride"]) if "proj" in blk \
            else x
        x = F.relu(h + sc)
    return _pool_head(x, p["head"])


# ------------------------------------------------- MobileNetV3 / EffNet-B0
def _se_init(gen, c, device, r=4):
    return {"w1": conv_init(gen, 1, 1, c, max(1, c // r), device),
            "w2": conv_init(gen, 1, 1, max(1, c // r), c, device)}


def _se(p, x):
    s = x.mean(dim=(2, 3), keepdim=True)
    s = torch.sigmoid(conv(F.relu(conv(s, p["w1"])), p["w2"]))
    return x * s


def _mbconv_init(gen, cin, cout, expand, stride, device, kernel=3):
    mid = cin * expand
    return {"expand": conv_init(gen, 1, 1, cin, mid, device),
            "bn_e": bn_init(mid, device),
            # depthwise: one input channel per group
            "dw": conv_init(gen, kernel, kernel, 1, mid, device),
            "bn_d": bn_init(mid, device),
            "se": _se_init(gen, mid, device),
            "proj": conv_init(gen, 1, 1, mid, cout, device),
            "bn_p": bn_init(cout, device),
            "stride": stride}


def _mbconv(blk, x):
    h = F.hardswish(bn(blk["bn_e"], conv(x, blk["expand"])))
    h = F.hardswish(bn(blk["bn_d"], conv(h, blk["dw"], stride=blk["stride"],
                                         groups=h.shape[1])))
    h = _se(blk["se"], h)
    h = bn(blk["bn_p"], conv(h, blk["proj"]))
    if blk["stride"] == 1 and x.shape[1] == h.shape[1]:
        h = h + x
    return h


def mobilenetv3_init(seed=0, n_classes=1000, width=8, device="cuda"):
    gen = _generator(seed, device)
    p: Dict = {"stem": conv_init(gen, 3, 3, 3, width, device),
               "stem_bn": bn_init(width, device), "blocks": []}
    spec = [(width, 1, 1), (2 * width, 4, 2), (2 * width, 3, 1),
            (4 * width, 4, 2), (6 * width, 4, 1), (10 * width, 6, 2)]
    cin = width
    for cout, expand, stride in spec:
        p["blocks"].append(_mbconv_init(gen, cin, cout, expand, stride,
                                        device))
        cin = cout
    p["head1"] = conv_init(gen, 1, 1, cin, 4 * cin, device)
    p["head_bn"] = bn_init(4 * cin, device)
    p["head2"] = dense_init(gen, 4 * cin, n_classes, torch.float32, device)
    return p


@_nhwc_forward
def mobilenetv3_apply(p, x):
    x = F.hardswish(bn(p["stem_bn"], conv(x, p["stem"], stride=2)))
    for blk in p["blocks"]:
        x = _mbconv(blk, x)
    x = F.hardswish(bn(p["head_bn"], conv(x, p["head1"])))
    return _pool_head(x, p["head2"])


efficientnet_b0_init = mobilenetv3_init   # same MBConv family
efficientnet_b0_apply = mobilenetv3_apply


# ---------------------------------------------------------------- Inception
def _inception_block_init(gen, cin, c1, c3, c5, cp, device):
    return {"b1": conv_init(gen, 1, 1, cin, c1, device),
            "b3a": conv_init(gen, 1, 1, cin, c3 // 2, device),
            "b3b": conv_init(gen, 3, 3, c3 // 2, c3, device),
            "b5a": conv_init(gen, 1, 1, cin, c5 // 2, device),
            "b5b": conv_init(gen, 5, 5, c5 // 2, c5, device),
            "bp": conv_init(gen, 1, 1, cin, cp, device)}


def _inception_block(p, x):
    b1 = F.relu(conv(x, p["b1"]))
    b3 = F.relu(conv(F.relu(conv(x, p["b3a"])), p["b3b"]))
    b5 = F.relu(conv(F.relu(conv(x, p["b5a"])), p["b5b"]))
    bp = F.relu(conv(_max_pool(x, 3, 1), p["bp"]))
    return torch.cat([b1, b3, b5, bp], dim=1)


def inception_v3_init(seed=0, n_classes=1000, width=8, device="cuda"):
    gen = _generator(seed, device)
    p: Dict = {"stem": conv_init(gen, 3, 3, 3, 2 * width, device),
               "stem_bn": bn_init(2 * width, device), "blocks": []}
    cin = 2 * width
    for mult in (1, 2, 3):
        c = width * mult
        p["blocks"].append(_inception_block_init(gen, cin, c, 2 * c, c, c,
                                                 device))
        cin = c + 2 * c + c + c
    p["head"] = dense_init(gen, cin, n_classes, torch.float32, device)
    return p


@_nhwc_forward
def inception_v3_apply(p, x):
    x = F.relu(bn(p["stem_bn"], conv(x, p["stem"], stride=2)))
    for blk in p["blocks"]:
        x = _max_pool(_inception_block(blk, x), 3, 2)
    return _pool_head(x, p["head"])


# ---------------------------------------------------------------- YOLOv5s
def _csp_init(gen, cin, cout, device):
    return {"c1": conv_init(gen, 1, 1, cin, cout // 2, device),
            "c2": conv_init(gen, 1, 1, cin, cout // 2, device),
            "c3": conv_init(gen, 3, 3, cout // 2, cout // 2, device),
            "merge": conv_init(gen, 1, 1, cout, cout, device),
            "bn": bn_init(cout, device)}


def _csp(p, x):
    a = F.silu(conv(x, p["c1"]))
    a = a + F.silu(conv(a, p["c3"]))
    b = F.silu(conv(x, p["c2"]))
    return F.silu(bn(p["bn"], conv(torch.cat([a, b], dim=1), p["merge"])))


def yolov5s_init(seed=0, n_classes=80, n_anchors=3, width=8, device="cuda"):
    gen = _generator(seed, device)
    p: Dict = {"stem": conv_init(gen, 6, 6, 3, width, device),
               "stem_bn": bn_init(width, device), "stages": []}
    cin = width
    for mult in (2, 4, 8):
        cout = width * mult
        p["stages"].append({"down": conv_init(gen, 3, 3, cin, cout, device),
                            "bn": bn_init(cout, device),
                            "csp": _csp_init(gen, cout, cout, device)})
        cin = cout
    p["detect"] = conv_init(gen, 1, 1, cin, n_anchors * (5 + n_classes),
                            device)
    return p


@_nhwc_forward
def yolov5s_apply(p, x):
    """Returns the detection map (B, H', W', anchors * (5 + classes))."""
    x = F.silu(bn(p["stem_bn"], conv(x, p["stem"], stride=2)))
    for st in p["stages"]:
        x = F.silu(bn(st["bn"], conv(x, st["down"], stride=2)))
        x = _csp(st["csp"], x)
    return conv(x, p["detect"]).permute(0, 2, 3, 1)


# ---------------------------------------------------------------- TinyBERT
def tinybert_init(seed=0, vocab=30522, d=128, n_layers=4, n_heads=2,
                  n_classes=35, device="cuda"):
    """TinyBERT's (params, config): the reference's trunk config
    (``cnn.py:251-254``) and a classifier head."""
    from repro_torch.models.transformer import init_params

    cfg = ModelConfig(name="_tinybert", family="dense", n_layers=n_layers,
                      d_model=d, n_heads=n_heads, n_kv_heads=n_heads,
                      d_ff=4 * d, vocab_size=vocab, norm="layernorm",
                      activation="gelu", rope="rope")
    p = init_params(cfg, seed=seed, device=device)
    p["cls"] = dense_init(_generator(seed + 1, device), d, n_classes,
                          torch.float32, device)
    return p, cfg


@torch.no_grad()
def tinybert_apply(params_cfg, tokens):
    """Speech-command classification over a token sequence (B, T): the
    trunk's causal attention (``flash_attention``), mean-pooled."""
    from repro_torch.models.transformer import _embed_inputs, _trunk_full

    p, cfg = params_cfg
    x, ctx = _embed_inputs(p, {"tokens": tokens}, cfg)
    x, _, _ = _trunk_full(p, x, cfg, {**ctx, "cache": False})
    return x.mean(dim=1) @ p["cls"]


EDGE_NETS = {
    "res": (resnet18_init, resnet18_apply),
    "mob": (mobilenetv3_init, mobilenetv3_apply),
    "eff": (efficientnet_b0_init, efficientnet_b0_apply),
    "inc": (inception_v3_init, inception_v3_apply),
    "yolo": (yolov5s_init, yolov5s_apply),
}


# ---------------------------------------------------------------- bridges
def edge_params_from_jax(params_np: Any, device="cpu") -> Any:
    """An edge net's params from the reference's with numpy leaves: HWIO
    conv weights become ``(C_out, C_in / groups, kh, kw)``, dense heads
    ``(in, out)`` and norm vectors cross as they are, and the 0-d
    ``stride`` leaves become ints."""
    if isinstance(params_np, dict):
        return {k: int(np.asarray(v)) if k == "stride"
                else edge_params_from_jax(v, device)
                for k, v in params_np.items()}
    if isinstance(params_np, (list, tuple)):
        return [edge_params_from_jax(v, device) for v in params_np]
    t = torch.from_numpy(np.array(params_np, dtype=np.float32, copy=True))
    if t.ndim == 4:
        t = t.permute(3, 2, 0, 1).contiguous()
    return t.to(device)


def tinybert_params_from_jax(params_np: Dict, cfg_np,
                             device="cpu") -> Tuple[Dict, ModelConfig]:
    """TinyBERT's (params, config) from the reference's: the trunk
    through ``models.bridge``, the classifier as it is."""
    from repro_torch.models.bridge import params_from_jax

    cfg = ModelConfig(**dataclasses.asdict(cfg_np))
    p = params_from_jax(params_np, cfg, device)
    p["cls"] = torch.from_numpy(np.array(params_np["cls"], copy=True)).to(
        device)
    return p, cfg
