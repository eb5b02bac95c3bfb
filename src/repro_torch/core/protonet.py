"""Prototypical-network learning as an equivalent FC layer — the paper's
central contribution (§III-A, Eq. 3–6 and the log2 form Eq. 8).

The port of ``repro/core/protonet.py``.  With prototypes P_j = s^j / k
(s^j = sum of the k support embeddings of way j), argmin_j ||P_j - x||^2
is an FC layer with W_j = s^j and b_j = -(1/2k)||s^j||^2 followed by
argmax: learning is a forward pass plus a segment sum.  ``adapt`` does
steps 2+3 through the ``proto_extract`` kernel's label entry on CUDA
tensors (its plain version on CPU tensors).  The prototype store keeps
the reference's overflow contract.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.quant.log2 import compute_scale, dequantize_log2, quantize_log2


# ---------------------------------------------------------------------------
# Eq. 3–6: exact PN -> FC extraction
# ---------------------------------------------------------------------------

def support_sums(embeddings: torch.Tensor, labels: torch.Tensor, n_ways: int):
    """s^j = sum over the k shots of way j.  embeddings (N*k, V); labels
    (N*k,).  Returns (n_ways, V).

    Summed in an order fixed by the shapes alone, on every device: a
    one-hot mask picks each way's rows (the others add exact zeros) and
    ``sum_last`` sums over the rows.  ``index_add_`` on a CUDA tensor adds
    with atomics once there are more than 16 rows, in an order that
    changes from call to call (25 and 30 rows gave other bits within 200
    calls on an H100), and a training step must repeat bit for bit."""
    ways = torch.arange(n_ways, device=embeddings.device)
    onehot = (labels.long()[None, :] == ways[:, None]).to(embeddings.dtype)
    return sum_last(onehot[:, None, :] * embeddings.T[None])


def pn_fc_from_sums(s: torch.Tensor, k: int):
    """Eq. 6: W_j = s^j, b_j = -(1/2k)||s^j||^2.  Returns (W (N,V), b (N,))."""
    return s, -(s * s).sum(dim=-1) / (2.0 * k)


def pn_fc_from_sums_log2(s: torch.Tensor, k: int):
    """Eq. 8, the MatMul-free variant: s quantized to 4-bit log2 codes, the
    square inside the bias an exponent doubling, the 1/2k a shift by
    ceil(log2 k) + 1.  Returns (W_deq, b, codes, scale)."""
    scale = compute_scale(s)
    q = quantize_log2(s, scale)
    w = dequantize_log2(q, scale)
    e2 = 2.0 * (1.0 - q.to(torch.float32).abs())  # doubled exponent
    sq = torch.where(q == 0, torch.zeros_like(e2), torch.exp2(e2)) \
        * (scale ** 2)
    k_shift = 2.0 ** math.ceil(math.log2(float(k)))
    b = -sq.sum(dim=-1) / (2.0 * k_shift)
    return w, b, q, scale


def pn_logits(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """(B, V) -> (B, N) through the equivalent FC layer."""
    return x @ w.T + b[None, :]


def sum_last(p: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis in an order fixed by its length alone:
    pairwise halving (the upper half added to the lower, an odd last
    element carried to the next level), one elementwise add per level.
    Each add rounds once per element on every device, so a row's sum does
    not depend on the other axes' sizes, on the batch or on the device.
    A library product or reduction promises none of that: torch's einsum
    over (S, V) x (S, N, V) gives other bits at N=250 than at N=256 on the
    CPU, which would break paged == dense (their table widths differ)."""
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        s = p[..., :h] + p[..., h:2 * h]
        p = torch.cat([s, p[..., 2 * h:]], dim=-1) if p.shape[-1] % 2 else s
    return p[..., 0]


#: most fp32 elements one (S, T', N, V) product of ``pn_logits_rows`` may
#: hold (64 MiB): a 16-step tick of 64 slots x 256 ways x V=64 is one group
ROWS_PRODUCT_ELEMS = 1 << 24


def pn_logits_rows(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor):
    """Each query row against its own FC rows, already gathered: x (S, V)
    or (S, T, V) (T steps of each row); w (S, N, V); b (S, N).  Returns
    (S, N) or (S, T, N).  Products and sums are elementwise in a fixed
    order (``sum_last``), so a step's logits have the same bits whatever
    N, S or T.  Steps go in groups whose product stays within
    ``ROWS_PRODUCT_ELEMS``, so a long chunk does not build all its steps'
    products at once."""
    if x.dim() == 2:
        return sum_last(x[:, None, :] * w) + b
    S, T, V = x.shape
    g = max(1, ROWS_PRODUCT_ELEMS // max(1, S * w.shape[1] * V))
    if T <= g:
        return sum_last(x[:, :, None, :] * w[:, None]) + b[:, None]
    return torch.cat([pn_logits_rows(x[:, t:t + g], w, b)
                      for t in range(0, T, g)], dim=1)


def pn_logits_banked(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     bank_ids: torch.Tensor):
    """Each query row classifies against its own bank's FC rows.  x (S, V);
    w (T, N, V); b (T, N); bank_ids (S,) (negative ids clamp to 0 —
    callers mask those rows).  Returns (S, N)."""
    ids = torch.clamp(bank_ids.long(), 0, w.shape[0] - 1)
    return pn_logits_rows(x, w[ids], b[ids])


def l2_classify(x: torch.Tensor, prototypes: torch.Tensor):
    """Oracle: argmin_j ||P_j - x||^2 (tests and chip checks only).
    Returns (argmin (B,), squared distances (B, N))."""
    d2 = torch.square(x[:, None, :] - prototypes[None]).sum(dim=-1)
    return torch.argmin(d2, dim=-1), d2


# ---------------------------------------------------------------------------
# Few-shot adaptation (the "learning controller" + "parameter extractor")
# ---------------------------------------------------------------------------

def adapt(embed_fn, params, support_batch, labels, n_ways: int, k: int,
          *, log2: bool = False, backend: str | None = None):
    """End-to-end FSL (Fig. 6): embed the N*k support samples, then
    extract the FC params.  Returns (W, b).

    The fp32 form goes through ``proto_extract``'s label entry (W and b
    in one pass, straight from the labels: on the card one launch after
    the embedder, on the CPU the plain version on the one-hot built by
    comparison), the backend checked against the device the embeddings
    land on.  A label outside [0, n_ways) counts for no way in either
    form, as in the reference, whose ``jax.nn.one_hot`` gives it a zero
    column.  The log2 form (Eq. 8) stays plain PyTorch: its exponent
    doubling is already MatMul-free."""
    emb = embed_fn(params, support_batch).to(torch.float32).contiguous()
    if log2:
        w, b, _, _ = pn_fc_from_sums_log2(support_sums(emb, labels, n_ways), k)
        return w, b
    from repro_torch.kernels import dispatch
    from repro_torch.kernels.proto_extract import proto_extract_labels
    dispatch.resolve(backend, emb.device)
    if labels.dtype not in (torch.int32, torch.int64):
        labels = labels.long()
    return proto_extract_labels(emb, labels.contiguous(), n_ways, k)


# ---------------------------------------------------------------------------
# Continual learning: a growable prototype store
# ---------------------------------------------------------------------------

class PrototypeStore(NamedTuple):
    """CL state: FC rows for up to max_ways classes, with the running sums
    and counts so a class can take more shots later (Eq. 3)."""
    s_sums: torch.Tensor   # (max_ways, V)
    counts: torch.Tensor   # (max_ways,)
    n_ways: torch.Tensor   # () int32


def store_init(max_ways: int, dim: int, device="cuda") -> PrototypeStore:
    return PrototypeStore(
        s_sums=torch.zeros((max_ways, dim), device=device),
        counts=torch.zeros((max_ways,), device=device),
        n_ways=torch.zeros((), dtype=torch.int32, device=device))


def store_add_class(store: PrototypeStore, shot_embeddings) -> PrototypeStore:
    """Learn one new class from its k shot embeddings (k, V).

    Overflow contract: at ``n_ways == max_ways`` the update is a masked
    no-op — the store comes back unchanged (n_ways does not increment, no
    row is overwritten).  Counts use set, not add, so a re-learned row
    never inherits its previous occupant's count."""
    max_ways = store.s_sums.shape[0]
    ok = store.n_ways < max_ways
    idx = torch.clamp(store.n_ways, max=max_ways - 1)
    hit = (torch.arange(max_ways, device=store.s_sums.device) == idx) & ok
    s = shot_embeddings.to(torch.float32).sum(dim=0)
    k = float(shot_embeddings.shape[0])
    return PrototypeStore(
        s_sums=torch.where(hit[:, None], s[None, :], store.s_sums),
        counts=torch.where(hit, torch.full_like(store.counts, k),
                           store.counts),
        n_ways=store.n_ways + ok.to(torch.int32))


def store_update_class(store: PrototypeStore, idx: int,
                       shot_embeddings) -> PrototypeStore:
    """Add more shots to an existing class (prototype refinement)."""
    s_sums = store.s_sums.clone()
    counts = store.counts.clone()
    s_sums[idx] += shot_embeddings.to(torch.float32).sum(dim=0)
    counts[idx] += shot_embeddings.shape[0]
    return PrototypeStore(s_sums, counts, store.n_ways)


def store_fc(store: PrototypeStore):
    """FC weights/bias over the learned ways, in the normalized form
    W_j = s_j/k_j, b_j = -||W_j||^2/2 (the store allows unequal counts).
    Unlearned rows get bias -inf so they never win the argmax."""
    w = store.s_sums / torch.clamp(store.counts, min=1.0)[..., None]
    b = -sum_last(w * w) / 2.0
    live = torch.arange(store.s_sums.shape[-2], device=w.device) \
        < store.n_ways[..., None]
    return w, torch.where(live, b, torch.full_like(b, -math.inf))


def store_classify(store: PrototypeStore, emb: torch.Tensor):
    w, b = store_fc(store)
    return torch.argmax(pn_logits(emb.to(torch.float32), w, b), dim=-1)
