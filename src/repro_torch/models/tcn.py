"""Temporal Convolutional Network — the paper's embedder (§III-B, Fig. 7).

The port of ``repro/models/tcn.py``: param defs and init, the forward in
train mode (batch-norm on batch statistics, running stats carried in a
state tree with momentum 0.9) or eval mode (running stats), either with
the QAT fake-quant (log2 weights through the straight-through estimator,
u4 activations at the fixed ``act_scale``), BN folding and the
session-open bake behind the fused kernel path, and the fused batch
forward.  Training runs through autograd over ``tcn_forward``; its convs
are ``causal_conv1d`` (``kernels/ref.dilated_conv_ref``: tap-shifted
matmuls, no cuDNN), as the eval forward's are.

Params are nested dicts of tensors in the reference's layout: conv weights
(K, Cin, Cout), activations (B, T, C).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.dispatch import require_device
from repro_torch.kernels.ref import dilated_conv_ref
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import ParamDef
from repro_torch.quant.log2 import (
    compute_scale,
    dequantize_log2,
    fake_quant_act_u4,
    fake_quant_log2,
    pack_nibbles,
    quantize_log2,
)

BN_EPS = 1e-5


def receptive_field(cfg: ArchConfig) -> int:
    k = cfg.tcn_kernel
    return 1 + sum(2 * (2 ** b) * (k - 1) for b in range(len(cfg.tcn_channels)))


def tcn_param_defs(cfg: ArchConfig) -> dict:
    k = cfg.tcn_kernel
    defs: dict = {"blocks": {}}
    c_in = cfg.tcn_in_channels
    for i, c_out in enumerate(cfg.tcn_channels):
        b: dict = {
            "conv1_w": ParamDef((k, c_in, c_out),
                                ("conv_k", "channels_in", "channels")),
            "conv1_b": ParamDef((c_out,), ("channels",), init="zeros"),
            "conv2_w": ParamDef((k, c_out, c_out),
                                ("conv_k", "channels_in", "channels")),
            "conv2_b": ParamDef((c_out,), ("channels",), init="zeros"),
            "bn1": {"scale": ParamDef((c_out,), ("channels",), init="ones"),
                    "bias": ParamDef((c_out,), ("channels",), init="zeros")},
            "bn2": {"scale": ParamDef((c_out,), ("channels",), init="ones"),
                    "bias": ParamDef((c_out,), ("channels",), init="zeros")},
        }
        if c_in != c_out:
            b["down_w"] = ParamDef((1, c_in, c_out),
                                   ("conv_k", "channels_in", "channels"))
            b["down_b"] = ParamDef((c_out,), ("channels",), init="zeros")
        defs["blocks"][f"b{i}"] = b
        c_in = c_out
    defs["head_w"] = ParamDef((c_in, cfg.embed_dim), ("channels_in", None))
    defs["head_b"] = ParamDef((cfg.embed_dim,), (None,), init="zeros")
    defs["fc"] = {
        "w": ParamDef((cfg.embed_dim, cfg.n_classes), (None, "proto"),
                      init="zeros"),
        "b": ParamDef((cfg.n_classes,), ("proto",), init="zeros"),
    }
    return defs


def init_params(defs, generator: torch.Generator, device="cuda") -> dict:
    """Materialize a ParamDef tree: normal leaves get fan-in scaling on the
    second-to-last dim, as in the reference.  Values are drawn on the CPU
    from ``generator`` (leaves in dict order), then moved to ``device``."""
    dev = require_device(device)

    def leaf(d: ParamDef):
        if d.init == "zeros":
            t = torch.zeros(d.shape)
        elif d.init == "ones":
            t = torch.ones(d.shape)
        elif d.init == "normal":
            fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
            t = torch.randn(d.shape, generator=generator) \
                * (1.0 / max(fan_in, 1)) ** 0.5
        else:
            raise ValueError(f"unknown init {d.init}")
        return t.to(dev)

    def walk(node):
        return {k: walk(v) for k, v in node.items()} \
            if isinstance(node, dict) else leaf(node)

    return walk(defs)


def tcn_empty_state(cfg: ArchConfig, device="cuda") -> dict:
    dev = require_device(device)
    return {f"b{i}": {"bn1_mean": torch.zeros(c, device=dev),
                      "bn1_var": torch.ones(c, device=dev),
                      "bn2_mean": torch.zeros(c, device=dev),
                      "bn2_var": torch.ones(c, device=dev)}
            for i, c in enumerate(cfg.tcn_channels)}


def causal_conv1d(x, w, b, dilation: int):
    """x: (B, T, Cin); w: (K, Cin, Cout).  Left-padded causal dilated conv
    (``kernels/ref.dilated_conv_ref``), weights and bias in x's dtype."""
    return dilated_conv_ref(x, w.to(x.dtype), b.to(x.dtype), dilation)


def _bn(x, scale, bias, mean, var):
    inv = torch.rsqrt(var + BN_EPS)
    return (x - mean) * inv * scale + bias


def _bn_train(x, scale, bias, run_mean, run_var, momentum=0.9):
    """BN on the batch statistics over (B, T) (biased variance, as
    ``jnp.var``), and the updated running stats, detached: they are
    state, not a function of the params to differentiate."""
    mean = x.mean(dim=(0, 1))
    var = x.var(dim=(0, 1), correction=0)
    y = _bn(x, scale, bias, mean, var)
    new_mean = momentum * run_mean + (1 - momentum) * mean
    new_var = momentum * run_var + (1 - momentum) * var
    return y, new_mean.detach(), new_var.detach()


def tcn_forward(params, state, cfg: ArchConfig, x, *, train: bool = False,
                quantize: bool = False):
    """x: (B, T, C_in) -> (embedding (B, V), logits (B, n_classes),
    new_state).

    train=True normalizes on the batch statistics and returns the updated
    running stats; train=False uses the running stats in ``state`` and
    returns them unchanged.  quantize=True runs the QAT fake-quant path
    (log2 weights, u4 activations at the fixed scale)."""
    qw = fake_quant_log2 if quantize else (lambda w: w)
    qa = (lambda a: fake_quant_act_u4(a, cfg.act_scale)) if quantize \
        else (lambda a: a)

    def bn(y, p, st, ns, name):
        if not train:
            return _bn(y, p[name]["scale"], p[name]["bias"],
                       st[f"{name}_mean"], st[f"{name}_var"])
        y, ns[f"{name}_mean"], ns[f"{name}_var"] = _bn_train(
            y, p[name]["scale"], p[name]["bias"], st[f"{name}_mean"],
            st[f"{name}_var"])
        return y

    new_state = {}
    h = x
    for i in range(len(cfg.tcn_channels)):
        p = params["blocks"][f"b{i}"]
        st = state[f"b{i}"]
        ns = dict(st)
        d = 2 ** i
        y = causal_conv1d(h, qw(p["conv1_w"]), p["conv1_b"], d)
        y = qa(torch.relu(bn(y, p, st, ns, "bn1")))
        y = causal_conv1d(y, qw(p["conv2_w"]), p["conv2_b"], d)
        y = bn(y, p, st, ns, "bn2")
        if "down_w" in p:
            res = causal_conv1d(h, qw(p["down_w"]), p["down_b"], 1)
        else:
            res = h
        h = qa(torch.relu(y + res))
        new_state[f"b{i}"] = ns
    feat = h[:, -1, :]  # causal: last timestep sees the full receptive field
    emb = qa(torch.relu(feat @ qw(params["head_w"]) + params["head_b"]))
    logits = emb @ params["fc"]["w"] + params["fc"]["b"]
    return emb, logits, new_state


def _copy_tree(node):
    return {k: _copy_tree(v) for k, v in node.items()} \
        if isinstance(node, dict) else node


def fold_bn(params, state, cfg: ArchConfig):
    """Fold BN into conv weights/biases (deployment, paper §IV-A).
    Returns (params', bn_state') where conv+bias reproduces conv+BN with
    running stats and BN becomes the identity."""
    out = _copy_tree(params)
    for i in range(len(cfg.tcn_channels)):
        p = out["blocks"][f"b{i}"]
        st = state[f"b{i}"]
        for conv, bn in (("conv1", "bn1"), ("conv2", "bn2")):
            scale = p[bn]["scale"] / torch.sqrt(st[f"{bn}_var"] + BN_EPS)
            p[f"{conv}_w"] = p[f"{conv}_w"] * scale[None, None, :]
            p[f"{conv}_b"] = (p[f"{conv}_b"] - st[f"{bn}_mean"]) * scale \
                + p[bn]["bias"]
            p[bn] = {"scale": torch.ones_like(scale),
                     "bias": torch.zeros_like(scale)}
    new_state = {name: {"bn1_mean": torch.zeros_like(b["bn1_mean"]),
                        "bn1_var": torch.ones_like(b["bn1_var"]) * (1.0 - BN_EPS),
                        "bn2_mean": torch.zeros_like(b["bn2_mean"]),
                        "bn2_var": torch.ones_like(b["bn2_var"]) * (1.0 - BN_EPS)}
                 for name, b in state.items()}
    return out, new_state


def _bake_weight(w, quantize: bool):
    """One weight's (scan_value, fused_value) pair: fp32 twice, or, when
    quantized, the log2 fake-quant VALUE for the scan path and the
    nibble-packed codes for the fused kernels (odd last axis stays fp32)."""
    if not quantize:
        return w, w
    s = compute_scale(w)
    q = quantize_log2(w, s)
    wq = dequantize_log2(q, s)
    if w.shape[-1] % 2 == 0:
        return wq, {"codes": pack_nibbles(q), "scale": s}
    return wq, wq


def bake_stream_params(params, state, cfg: ArchConfig, *,
                       quantize: bool = False):
    """Session-open transform behind the fused path.  Returns
    ``(scan_params, scan_bn, fused_params)``: the BN-folded (and, when
    quantized, pre-fake-quantized) params for the per-step scan path, and
    the kernel-layout tree (packed codes, no BN leaves) for the fused
    kernels.  Inference only."""
    folded, fbn = fold_bn(params, state, cfg)
    fused: dict = {"blocks": {}}
    for i in range(len(cfg.tcn_channels)):
        name = f"b{i}"
        p = folded["blocks"][name]
        fp = {}
        for cv in ("conv1", "conv2"):
            p[f"{cv}_w"], fp[f"{cv}_w"] = _bake_weight(p[f"{cv}_w"], quantize)
            fp[f"{cv}_b"] = p[f"{cv}_b"]
        if "down_w" in p:
            p["down_w"], fp["down_w"] = _bake_weight(p["down_w"], quantize)
            fp["down_b"] = p["down_b"]
        fused["blocks"][name] = fp
    folded["head_w"], fused["head_w"] = _bake_weight(folded["head_w"], quantize)
    fused["head_b"] = folded["head_b"]
    fused["fc"] = folded["fc"]  # the PN head is never quantized
    return folded, fbn, fused


def make_fused_forward(cfg: ArchConfig, *, quantize: bool = False,
                       backend: str | None = None, device="cuda"):
    """Batch forward through the fused block kernels (backend resolved
    ONCE for ``device``).  Returns ``forward(fused_params, x) -> (emb
    (B, V), logits)``: zero history strips, so it equals the fused chunk
    executor run from a fresh stream state."""
    from repro_torch.kernels.ref import expand_weight
    from repro_torch.kernels.tcn_block import make_block_fn

    block_fn = make_block_fn(backend or cfg.kernel_backend,
                             require_device(device))
    k = cfg.tcn_kernel
    qa = (lambda a: fake_quant_act_u4(a, cfg.act_scale)) if quantize \
        else (lambda a: a)

    def forward(fused_params, x):
        B = x.shape[0]
        h = x
        for i, c in enumerate(cfg.tcn_channels):
            d = 2 ** i
            n = (k - 1) * d
            strip1 = torch.nn.functional.pad(h, (0, 0, n, 0)).contiguous()
            hist2 = h.new_zeros((B, n, c))
            h, _ = block_fn(strip1, hist2, fused_params["blocks"][f"b{i}"],
                            dilation=d, k=k, act_scale=cfg.act_scale,
                            quantize=quantize)
        feat = h[:, -1, :]
        emb = feat @ expand_weight(fused_params["head_w"]) \
            + fused_params["head_b"]
        emb = qa(torch.relu(emb))
        logits = emb @ fused_params["fc"]["w"] + fused_params["fc"]["b"]
        return emb, logits

    return forward
