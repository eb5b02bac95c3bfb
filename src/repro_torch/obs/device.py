"""Device-side counters: how much of a tick's fixed grid did real work.

The port of ``repro/obs/device.py``, as functions on tensors.  The slot
grid's tick is shape-static (masked lanes and padded steps still run), so
its efficiency is computed on the device, from tensors the tick already
holds, as a few reductions whose result comes back with the tick's
outputs:

  * ``occupancy_stats(lengths, t_pad)`` -> (4,) int32
        [live_steps, total_steps, live_lanes, n_lanes]
    from the per-lane valid-prefix lengths the service uploads for the
    tick; ``decode_occupancy`` derives the ratios on the host;
  * ``valid_stats(valid)``: the same vector from an (S, T) validity mask;
  * ``acceptance_stats(ys, draft, n_draft)`` -> (S,) int32 accepted-draft
    counts of a speculative verify (the length of each lane's matching
    prefix).

The counters read the lengths only: the session state and outputs are
the same bits with them on or off (tests/test_torch_obs.py).  Off by
default: a service computes them only with ``device_counters=True`` (or
``REPRO_TORCH_DEVICE_COUNTERS=1``).
"""

from __future__ import annotations

import torch

from repro_torch.configs.runtime import ENV_DEVICE_COUNTERS, env_bool

ENV_VAR = ENV_DEVICE_COUNTERS


def env_device_counters() -> bool:
    return env_bool(ENV_VAR)


def occupancy_stats(lengths, t_pad: int) -> torch.Tensor:
    """(S,) per-lane valid-prefix lengths -> (4,) int32 stats vector
    [live_steps, total_steps, live_lanes, n_lanes], on the lengths'
    device."""
    lengths = torch.as_tensor(lengths).to(torch.int32)
    s = lengths.shape[0]
    # the constants are filled on the device: a host-built tensor would
    # be a blocking copy
    const = lambda v: torch.full((), v, dtype=torch.int32,
                                 device=lengths.device)
    return torch.stack([lengths.sum(dtype=torch.int32), const(s * t_pad),
                        (lengths > 0).sum(dtype=torch.int32), const(s)])


def valid_stats(valid) -> torch.Tensor:
    """(S, T) bool validity mask -> the same (4,) int32 vector (the mask
    is the prefix lengths' ``lengths_to_valid``, so its row sums recover
    them)."""
    valid = torch.as_tensor(valid)
    return occupancy_stats(valid.sum(dim=1), valid.shape[1])


def acceptance_stats(ys, draft, n_draft) -> torch.Tensor:
    """Per-lane accepted-draft counts of one verify dispatch.

    ys (S, K+1) verify outputs, draft (S, K) proposed tokens, n_draft (S,)
    valid drafts per lane.  Returns (S,) int32: the length of each lane's
    matching prefix."""
    ys, draft = torch.as_tensor(ys), torch.as_tensor(draft)
    n_draft = torch.as_tensor(n_draft).to(ys.device)
    k = draft.shape[1]
    match = (ys[:, :k] == draft) & (
        torch.arange(k, device=ys.device)[None, :] < n_draft[:, None])
    # 1 while the prefix matches, 0 from the first mismatch on: the row sum
    # is the matching prefix's length
    return torch.cumprod(match.to(torch.int32), dim=1).sum(
        dim=1, dtype=torch.int32)


def decode_occupancy(stats) -> dict:
    """Host-side view of an ``occupancy_stats`` vector.

      live_step_ratio  live / total grid steps (masked-vs-live);
      lane_occupancy   lanes doing any work / lanes of the grid;
      pad_waste        padded-but-dead steps within live lanes / their
                       padded extent (the power-of-two bucket's overhang)."""
    live, total, lanes_live, lanes = (int(x) for x in stats)
    t_pad = total // lanes if lanes else 0
    live_extent = lanes_live * t_pad
    return {
        "live_steps": live,
        "total_steps": total,
        "live_lanes": lanes_live,
        "lanes": lanes,
        "live_step_ratio": live / total if total else 0.0,
        "lane_occupancy": lanes_live / lanes if lanes else 0.0,
        "pad_waste": 1.0 - live / live_extent if live_extent else 0.0,
    }
