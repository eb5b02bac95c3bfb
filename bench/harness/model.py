"""Seeded weights of a configuration, made on the device.

The raw parameters in the program's public layout (conv weights (K, Cin,
Cout), activations channel-last) and a BN running state, drawn from one
generator on the device in two calls.  The program and the reference both
start from these tensors; the program bakes its own copy.
"""

from __future__ import annotations

import torch


def _leaves(sizes: dict) -> list[tuple[tuple, tuple, str]]:
    """(path, shape, kind) of every raw parameter, in a fixed order."""
    k, V = sizes["tcn_kernel"], sizes["embed_dim"]
    out = []
    c_in = sizes["tcn_in_channels"]
    for i, c in enumerate(sizes["tcn_channels"]):
        b = ("blocks", f"b{i}")
        out += [(b + ("conv1_w",), (k, c_in, c), f"w{k * c_in}"),
                (b + ("conv1_b",), (c,), "bias"),
                (b + ("conv2_w",), (k, c, c), f"w{k * c}"),
                (b + ("conv2_b",), (c,), "bias"),
                (b + ("bn1", "scale"), (c,), "gain"),
                (b + ("bn1", "bias"), (c,), "bias"),
                (b + ("bn2", "scale"), (c,), "gain"),
                (b + ("bn2", "bias"), (c,), "bias")]
        if c_in != c:
            out += [(b + ("down_w",), (1, c_in, c), f"w{c_in}"),
                    (b + ("down_b",), (c,), "bias")]
        c_in = c
    out += [(("head_w",), (c_in, V), f"w{c_in}"), (("head_b",), (V,), "bias"),
            (("fc", "w"), (V, sizes["n_classes"]), f"w{V}"),
            (("fc", "b"), (sizes["n_classes"],), "bias")]
    return out


def _put(tree: dict, path: tuple, value) -> None:
    for key in path[:-1]:
        tree = tree.setdefault(key, {})
    tree[path[-1]] = value


def make_weights(sizes: dict, seed: int, device) -> tuple[dict, dict]:
    """(raw params, BN state) from ``seed``: weights N(0, 1/fan_in) with
    fan_in = taps x input channels, biases and BN shifts N(0, 0.1^2), BN
    gains 1 + N(0, 0.1^2), running variances in [1, 1.2)."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    leaves = _leaves(sizes)
    chans = sizes["tcn_channels"]
    n = sum(torch.Size(s).numel() for _, s, _ in leaves) + 2 * sum(chans)
    z = torch.randn(n, generator=g, device=device)
    u = torch.rand(2 * sum(chans), generator=g, device=device)
    raw: dict = {}
    off = 0
    for path, shape, kind in leaves:
        m = torch.Size(shape).numel()
        v = z[off:off + m].reshape(shape)
        off += m
        if kind.startswith("w"):
            v = v * float(kind[1:]) ** -0.5
        elif kind == "gain":
            v = 1.0 + 0.1 * v
        else:
            v = 0.1 * v
        _put(raw, path, v.contiguous())
    bn: dict = {}
    uoff = 0
    for i, c in enumerate(chans):
        for norm in ("bn1", "bn2"):
            bn.setdefault(f"b{i}", {})[f"{norm}_mean"] = \
                (0.1 * z[off:off + c]).contiguous()
            bn[f"b{i}"][f"{norm}_var"] = (1.0 + 0.2 * u[uoff:uoff + c]) \
                .contiguous()
            off += c
            uoff += c
    return raw, bn
