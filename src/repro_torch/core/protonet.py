"""Prototypical-network learning as an equivalent FC layer — the paper's
central contribution (§III-A, Eq. 3–6 and the log2 form Eq. 8).

The port of ``repro/core/protonet.py``.  With prototypes P_j = s^j / k
(s^j = sum of the k support embeddings of way j), argmin_j ||P_j - x||^2
is an FC layer with W_j = s^j and b_j = -(1/2k)||s^j||^2 followed by
argmax: learning is a forward pass plus a segment sum.  ``adapt`` does
steps 2+3 through the ``proto_extract`` kernel on CUDA tensors (its plain
version on CPU tensors).  The prototype store keeps the reference's
overflow contract.
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
    (N*k,).  Returns (n_ways, V)."""
    out = embeddings.new_zeros((n_ways, embeddings.shape[1]))
    return out.index_add_(0, labels.long(), embeddings)


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


def pn_logits_banked(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                     bank_ids: torch.Tensor):
    """Each query row classifies against its own bank's FC rows.  x (S, V);
    w (T, N, V); b (T, N); bank_ids (S,) (negative ids clamp to 0 —
    callers mask those rows).  Returns (S, N)."""
    ids = torch.clamp(bank_ids.long(), 0, w.shape[0] - 1)
    return torch.einsum("sv,snv->sn", x, w[ids]) + b[ids]


# ---------------------------------------------------------------------------
# Few-shot adaptation (the "learning controller" + "parameter extractor")
# ---------------------------------------------------------------------------

def adapt(embed_fn, params, support_batch, labels, n_ways: int, k: int,
          *, log2: bool = False, backend: str | None = None):
    """End-to-end FSL (Fig. 6): embed the N*k support samples, then
    extract the FC params.  Returns (W, b).

    The fp32 form goes through ``proto_extract`` (W and b in one pass,
    from the one-hot dispatch matrix), resolved once here for the device
    the embeddings land on.  The log2 form (Eq. 8) stays plain PyTorch:
    its exponent doubling is already MatMul-free."""
    emb = embed_fn(params, support_batch).to(torch.float32).contiguous()
    if log2:
        w, b, _, _ = pn_fc_from_sums_log2(support_sums(emb, labels, n_ways), k)
        return w, b
    from repro_torch.kernels.proto_extract import make_proto_extract_op
    op = make_proto_extract_op(backend, emb.device)
    onehot = torch.nn.functional.one_hot(labels.long(), n_ways).to(
        torch.float32).T.contiguous()
    return op(emb, onehot, k)


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
    b = -(w * w).sum(dim=-1) / 2.0
    live = torch.arange(store.s_sums.shape[-2], device=w.device) \
        < store.n_ways[..., None]
    return w, torch.where(live, b, torch.full_like(b, -math.inf))


def store_classify(store: PrototypeStore, emb: torch.Tensor):
    w, b = store_fc(store)
    return torch.argmax(pn_logits(emb.to(torch.float32), w, b), dim=-1)
