"""The paper's CNN workloads: ResNet34, MobileNetV2, ShuffleNetV2 (NHWC).

The JAX package's ``models/cnn.py`` in PyTorch. Activations stay NHWC and
weights HWIO (a 1x1 or 3x3 conv weight is (kh, kw, cin, cout), a depthwise
weight (kh, kw, 1, C)), so a parameter tree carried over from JAX lines up
leaf by leaf. MobileNetV2 and ShuffleNetV2 are depthwise-convolution heavy,
the op class whose multi-core cache thrashing motivates Swan's pruning of
execution choices (paper §3.1). With ``impl="pallas"`` their stride-1
depthwise convs run the hand-written kernel (``kernels/ops.depthwise_conv``,
its plain version on the CPU); that kernel has no gradient, as in the
reference, so a CNN trains on the plain path. Every other conv, and the
stride-2 depthwise ones, are ``F.conv2d`` as the reference leaves them to
``lax.conv_general_dilated``.

Normalization is channel GroupNorm (functional, no running statistics), as
in the reference.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _same_pad(size: int, k: int, stride: int):
    """(before, after) of XLA's SAME padding: the output has ceil(size /
    stride) positions and the odd pad goes after (for a 3x3 stride-2 conv
    on 32 positions: 0 before, 1 after)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(x, w, stride: int = 1, groups: int = 1):
    """x: (B,H,W,Cin) NHWC; w: (kh,kw,Cin/groups,Cout) HWIO; SAME padding.
    Returns (B,H',W',Cout)."""
    kh, kw = w.shape[0], w.shape[1]
    top, bottom = _same_pad(x.shape[1], kh, stride)
    left, right = _same_pad(x.shape[2], kw, stride)
    xc, wc = x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1)
    if (top, left) == (bottom, right):
        out = F.conv2d(xc, wc, stride=stride, padding=(top, left), groups=groups)
    else:  # F.conv2d pads symmetrically only
        out = F.conv2d(F.pad(xc, (left, right, top, bottom)), wc, stride=stride,
                       groups=groups)
    return out.permute(0, 2, 3, 1)


def depthwise_conv2d(x, w, stride: int = 1, impl: str = "naive"):
    """x: (B,H,W,C), w: (kh,kw,1,C)."""
    if impl == "pallas" and stride == 1:
        from repro_torch.kernels import ops as kops
        return kops.depthwise_conv(x, w[:, :, 0, :])
    return conv2d(x, w, stride=stride, groups=x.shape[-1])


def _gn(p, x, groups: int = 8):
    B, H, W, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    xf = x.float().reshape(B, H, W, g, C // g)
    mu = xf.mean((1, 2, 4), keepdim=True)
    var = (xf - mu).square().mean((1, 2, 4), keepdim=True)
    xf = ((xf - mu) * torch.rsqrt(var + 1e-5)).reshape(B, H, W, C)
    return (xf * p["scale"] + p["bias"]).to(x.dtype)


def _conv_init(gen, kh, kw, cin, cout, dtype):
    fan = kh * kw * cin
    w = torch.randn((kh, kw, cin, cout), generator=gen, device=gen.device)
    return (w * math.sqrt(2.0 / fan)).to(dtype)


def _norm_init(c, dtype, device):
    return {"scale": torch.ones((c,), dtype=dtype, device=device),
            "bias": torch.zeros((c,), dtype=dtype, device=device)}


def _fc_init(gen, cin, n_classes, dtype):
    return (torch.randn((cin, n_classes), generator=gen, device=gen.device)
            * 0.01).to(dtype)


def _stem(gen, cfg, c, dtype):
    return {"w": _conv_init(gen, 3, 3, cfg.in_channels, c, dtype),
            "n": _norm_init(c, dtype, gen.device)}


# --------------------------- ResNet34 --------------------------------------

def _init_resnet(gen, cfg, dtype):
    dev = gen.device
    p = {"stem": _stem(gen, cfg, cfg.cnn_widths[0], dtype), "stages": []}
    cin = cfg.cnn_widths[0]
    for w, n in zip(cfg.cnn_widths, cfg.cnn_stages):
        stage = []
        for _ in range(n):
            blk = {"w1": _conv_init(gen, 3, 3, cin, w, dtype), "n1": _norm_init(w, dtype, dev),
                   "w2": _conv_init(gen, 3, 3, w, w, dtype), "n2": _norm_init(w, dtype, dev)}
            if cin != w:
                blk["proj"] = _conv_init(gen, 1, 1, cin, w, dtype)
            stage.append(blk)
            cin = w
        p["stages"].append(stage)
    p["fc"] = _fc_init(gen, cin, cfg.n_classes, dtype)
    return p


def _apply_resnet(p, x, cfg, impl):
    x = F.relu(_gn(p["stem"]["n"], conv2d(x, p["stem"]["w"])))
    for si, stage in enumerate(p["stages"]):
        for bi, blk in enumerate(stage):
            stride = 2 if (si > 0 and bi == 0) else 1
            h = F.relu(_gn(blk["n1"], conv2d(x, blk["w1"], stride=stride)))
            h = _gn(blk["n2"], conv2d(h, blk["w2"]))
            skip = x
            if "proj" in blk:
                skip = conv2d(x, blk["proj"], stride=stride)
            elif stride != 1:
                skip = x[:, ::stride, ::stride]
            x = F.relu(h + skip)
    return x.mean((1, 2)) @ p["fc"]


# --------------------------- MobileNetV2 ------------------------------------

_MBN_STRIDES = (1, 2, 2, 2, 1, 2, 1)


def _init_mobilenet(gen, cfg, dtype):
    dev = gen.device
    p = {"stem": _stem(gen, cfg, 32, dtype), "stages": []}
    cin = 32
    for w, n, _ in zip(cfg.cnn_widths, cfg.cnn_stages, _MBN_STRIDES):
        stage = []
        for _ in range(n):
            exp = cin * 6 if cin != 16 else cin
            stage.append({
                "we": _conv_init(gen, 1, 1, cin, exp, dtype), "ne": _norm_init(exp, dtype, dev),
                "wd": _conv_init(gen, 3, 3, 1, exp, dtype), "nd": _norm_init(exp, dtype, dev),
                "wp": _conv_init(gen, 1, 1, exp, w, dtype), "np_": _norm_init(w, dtype, dev)})
            cin = w
        p["stages"].append(stage)
    p["head"] = {"w": _conv_init(gen, 1, 1, cin, 1280, dtype),
                 "n": _norm_init(1280, dtype, dev)}
    p["fc"] = _fc_init(gen, 1280, cfg.n_classes, dtype)
    return p


def _apply_mobilenet(p, x, cfg, impl):
    x = F.relu6(_gn(p["stem"]["n"], conv2d(x, p["stem"]["w"])))
    for si, stage in enumerate(p["stages"]):
        for bi, blk in enumerate(stage):
            stride = _MBN_STRIDES[si] if bi == 0 else 1
            h = F.relu6(_gn(blk["ne"], conv2d(x, blk["we"])))
            h = F.relu6(_gn(blk["nd"], depthwise_conv2d(h, blk["wd"], stride=stride,
                                                        impl=impl)))
            h = _gn(blk["np_"], conv2d(h, blk["wp"]))
            if stride == 1 and x.shape[-1] == h.shape[-1]:
                h = h + x
            x = h
    x = F.relu6(_gn(p["head"]["n"], conv2d(x, p["head"]["w"])))
    return x.mean((1, 2)) @ p["fc"]


# --------------------------- ShuffleNetV2 -----------------------------------

def _channel_shuffle(x, groups: int = 2):
    B, H, W, C = x.shape
    return x.reshape(B, H, W, groups, C // groups).transpose(3, 4).reshape(B, H, W, C)


def _init_shufflenet(gen, cfg, dtype):
    dev = gen.device
    p = {"stem": _stem(gen, cfg, 24, dtype), "stages": []}
    cin = 24
    for w, n in zip(cfg.cnn_widths, cfg.cnn_stages):
        stage = []
        half = w // 2
        for b in range(n):
            blk = {}
            if b == 0:  # downsample unit: both branches convolved, concat doubles
                blk.update({
                    "l_wd": _conv_init(gen, 3, 3, 1, cin, dtype), "l_nd": _norm_init(cin, dtype, dev),
                    "l_wp": _conv_init(gen, 1, 1, cin, half, dtype), "l_np": _norm_init(half, dtype, dev)})
            r_in, r_out = (cin, w - half) if b == 0 else (half, half)
            blk.update({
                "r_w1": _conv_init(gen, 1, 1, r_in, half, dtype), "r_n1": _norm_init(half, dtype, dev),
                "r_wd": _conv_init(gen, 3, 3, 1, half, dtype), "r_nd": _norm_init(half, dtype, dev),
                "r_wp": _conv_init(gen, 1, 1, half, r_out, dtype), "r_np": _norm_init(r_out, dtype, dev)})
            stage.append(blk)
            cin = w
        p["stages"].append(stage)
    p["head"] = {"w": _conv_init(gen, 1, 1, cin, 1024, dtype),
                 "n": _norm_init(1024, dtype, dev)}
    p["fc"] = _fc_init(gen, 1024, cfg.n_classes, dtype)
    return p


def _apply_shufflenet(p, x, cfg, impl):
    x = F.relu(_gn(p["stem"]["n"], conv2d(x, p["stem"]["w"])))
    for stage in p["stages"]:
        for blk in stage:
            if "l_wd" in blk:  # downsample unit
                left = _gn(blk["l_nd"], depthwise_conv2d(x, blk["l_wd"], stride=2, impl=impl))
                left = F.relu(_gn(blk["l_np"], conv2d(left, blk["l_wp"])))
                r = F.relu(_gn(blk["r_n1"], conv2d(x, blk["r_w1"])))
                r = _gn(blk["r_nd"], depthwise_conv2d(r, blk["r_wd"], stride=2, impl=impl))
            else:
                half = x.shape[-1] // 2
                left, r = x[..., :half], x[..., half:]
                r = F.relu(_gn(blk["r_n1"], conv2d(r, blk["r_w1"])))
                r = _gn(blk["r_nd"], depthwise_conv2d(r, blk["r_wd"], impl=impl))
            r = F.relu(_gn(blk["r_np"], conv2d(r, blk["r_wp"])))
            x = _channel_shuffle(torch.cat([left, r], -1))
    x = F.relu(_gn(p["head"]["n"], conv2d(x, p["head"]["w"])))
    return x.mean((1, 2)) @ p["fc"]


# --------------------------- public API -------------------------------------

_INITS = {"resnet": _init_resnet, "mobilenet": _init_mobilenet,
          "shufflenet": _init_shufflenet}
_APPLYS = {"resnet": _apply_resnet, "mobilenet": _apply_mobilenet,
           "shufflenet": _apply_shufflenet}


def init_cnn(gen: torch.Generator, cfg, dtype=torch.float32):
    """Parameters drawn from ``gen`` (on its device). The reference draws
    from a JAX key, so the numbers differ; the parity tests carry a JAX
    tree over instead (``models/convert.from_numpy_tree``)."""
    return _INITS[cfg.cnn_kind](gen, cfg, dtype)


def forward_cnn(params, cfg, images, impl: str = "naive"):
    """images: (B,H,W,Cin) -> logits (B, n_classes)."""
    return _APPLYS[cfg.cnn_kind](params, images, cfg, impl)


def loss_cnn(params, cfg, batch, impl: str = "naive"):
    """Mean cross-entropy of ``batch["images"]`` against ``batch["labels"]``
    in f32."""
    logits = forward_cnn(params, cfg, batch["images"], impl=impl).float()
    labels = batch["labels"].long()
    logz = torch.logsumexp(logits, -1)
    gold = logits.gather(1, labels[:, None])[:, 0]
    return (logz - gold).mean()
