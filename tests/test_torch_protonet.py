"""repro_torch.core.protonet and the dense tenant banks against the JAX
reference: adapt (through the ``proto_extract`` plain version) against the
JAX adapt on the Pallas kernel in interpret mode and on its segment-sum
path, Eq. 6/8 extraction, banked logits, and the prototype store and bank
ops including the overflow contract.  fp32 tolerance rtol=2e-4, atol=2e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import protonet as jp  # noqa: E402
from repro.sessions import tenancy as jten  # noqa: E402
from repro_torch.core import protonet as tp  # noqa: E402
from repro_torch.sessions import tenancy as tten  # noqa: E402

RTOL, ATOL = 2e-4, 2e-5


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=ATOL)


def _episode(seed, n_ways, k, V=16):
    rng = np.random.default_rng(seed)
    emb = np.abs(rng.normal(size=(n_ways * k, V))).astype(np.float32)
    labels = np.repeat(np.arange(n_ways), k).astype(np.int32)
    perm = rng.permutation(len(labels))  # shots arrive in any order
    return emb[perm], labels[perm]


@pytest.mark.parametrize("n_ways,k", [(5, 1), (5, 5), (3, 4)])
@pytest.mark.parametrize("j_backend", ["interpret", "ref"])
def test_adapt_matches_reference(n_ways, k, j_backend):
    emb, labels = _episode(n_ways * 10 + k, n_ways, k)
    wj, bj = jp.adapt(lambda p, b: jnp.asarray(emb), None, None,
                      jnp.asarray(labels), n_ways, k, backend=j_backend)
    wt, bt = tp.adapt(lambda p, b: torch.tensor(emb), None, None,
                      torch.tensor(labels), n_ways, k)
    _close(wt.numpy(), wj)
    _close(bt.numpy(), bj)


def test_adapt_log2_matches_reference():
    emb, labels = _episode(3, 5, 5)
    wj, bj = jp.adapt(lambda p, b: jnp.asarray(emb), None, None,
                      jnp.asarray(labels), 5, 5, log2=True)
    wt, bt = tp.adapt(lambda p, b: torch.tensor(emb), None, None,
                      torch.tensor(labels), 5, 5, log2=True)
    _close(wt.numpy(), wj)
    _close(bt.numpy(), bj)


def test_adapt_kernel_path_equals_segment_sum_path():
    emb, labels = _episode(4, 5, 5)
    e, lab = torch.tensor(emb), torch.tensor(labels)
    w, b = tp.adapt(lambda p, x: e, None, None, lab, 5, 5)
    ws, bs = tp.pn_fc_from_sums(tp.support_sums(e, lab, 5), 5)
    torch.testing.assert_close(w, ws, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(b, bs, rtol=1e-5, atol=1e-6)


def test_pn_logits_and_banked_match_reference():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 16)).astype(np.float32)
    w = rng.normal(size=(3, 4, 16)).astype(np.float32)
    b = rng.normal(size=(3, 4)).astype(np.float32)
    ids = np.array([0, 2, 1, -1, 2, 0], np.int32)
    _close(tp.pn_logits(torch.tensor(x), torch.tensor(w[0]), torch.tensor(b[0])).numpy(),
           jp.pn_logits(jnp.asarray(x), jnp.asarray(w[0]), jnp.asarray(b[0])))
    _close(tp.pn_logits_banked(torch.tensor(x), torch.tensor(w), torch.tensor(b),
                               torch.tensor(ids)).numpy(),
           jp.pn_logits_banked(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                               jnp.asarray(ids)))


def test_prototype_store_matches_reference_incl_overflow():
    rng = np.random.default_rng(6)
    sj, st = jp.store_init(3, 8), tp.store_init(3, 8, "cpu")
    for i in range(5):  # two past capacity: masked no-ops
        shots = rng.normal(size=(2 + i % 2, 8)).astype(np.float32)
        sj = jp.store_add_class(sj, jnp.asarray(shots))
        st = tp.store_add_class(st, torch.tensor(shots))
    more = rng.normal(size=(2, 8)).astype(np.float32)
    sj = jp.store_update_class(sj, 1, jnp.asarray(more))
    st = tp.store_update_class(st, 1, torch.tensor(more))
    assert int(st.n_ways) == int(sj.n_ways) == 3
    _close(st.s_sums.numpy(), sj.s_sums)
    np.testing.assert_array_equal(st.counts.numpy(), np.asarray(sj.counts))
    wj, bj = jp.store_fc(sj)
    wt, bt = tp.store_fc(st)
    _close(wt.numpy(), wj)
    _close(bt.numpy(), bj)
    q = rng.normal(size=(10, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        tp.store_classify(st, torch.tensor(q)).numpy(),
        np.asarray(jp.store_classify(sj, jnp.asarray(q))))


def test_tenant_bank_ops_match_reference():
    rng = np.random.default_rng(7)
    bj, bt = jten.bank_init(3, 2, 8), tten.bank_init(3, 2, 8, "cpu")
    for tenant in (0, 2, 2, 2, 0):  # tenant 2 overflows its 2 ways
        shots = rng.normal(size=(3, 8)).astype(np.float32)
        bj = jten.bank_add_class(bj, tenant, jnp.asarray(shots))
        bt = tten.bank_add_class(bt, tenant, torch.tensor(shots))
    shots = rng.normal(size=(2, 8)).astype(np.float32)
    bj = jten.bank_update_class(bj, 0, 1, jnp.asarray(shots))
    bt = tten.bank_update_class(bt, 0, 1, torch.tensor(shots))
    np.testing.assert_array_equal(bt.n_ways.numpy(), np.asarray(bj.n_ways))
    np.testing.assert_array_equal(bt.counts.numpy(), np.asarray(bj.counts))
    _close(bt.s_sums.numpy(), bj.s_sums)
    (wj, fj), (wt, ft) = jten.bank_fc(bj), tten.bank_fc(bt)
    _close(wt.numpy(), wj)
    _close(ft.numpy(), fj)
    row = tten.bank_pack_tenant(bt, 2)
    assert set(row) == set(jten.bank_pack_tenant(bj, 2))
    bt = tten.bank_clear_tenant(bt, 2)
    bj = jten.bank_clear_tenant(bj, 2)
    np.testing.assert_array_equal(bt.n_ways.numpy(), np.asarray(bj.n_ways))
    bt = tten.bank_unpack_tenant(bt, 1, row)
    np.testing.assert_array_equal(bt.s_sums[1].numpy(), row["s_sums"])
    assert tten.bank_row_bytes(bt) == jten.bank_row_bytes(bj)
