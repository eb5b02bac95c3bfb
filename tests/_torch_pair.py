"""Shared set-up of the serving-layer parity tests (test_torch_obs,
_protocol, _spill, _plane): the narrow chameleon-tcn of tests/test_chaos.py
built once in the JAX package and carried into the port as numpy arrays,
and the services of both packages over it.  The reference services run
fused with the plain ("ref") kernel backend; the port's run on the CPU."""

import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro.configs import get_config as j_get_config
from repro.models import build_bundle as j_build_bundle
from repro.models.tcn import tcn_empty_state as j_empty
from repro.sessions import StreamSessionService as JService
from repro_torch.configs import get_config
from repro_torch.convert import params_from_jax
from repro_torch.models import build_tcn_bundle
from repro_torch.sessions import StreamSessionService

RTOL, ATOL = 2e-4, 2e-5
SMALL = dict(tcn_channels=(8, 8), tcn_kernel=3, tcn_in_channels=2,
             embed_dim=12, n_classes=4)


@functools.lru_cache(maxsize=None)
def setup(seed: int = 0):
    """(JAX bundle, params, bn; port bundle, params, bn) on the CPU."""
    jcfg = j_get_config("chameleon-tcn").replace(kernel_backend="ref", **SMALL)
    cfg = get_config("chameleon-tcn").replace(**SMALL)
    jbundle = j_build_bundle(jcfg)
    params = jbundle.init(jax.random.key(seed))
    rng = np.random.default_rng(seed + 7)
    bn = jax.tree.map(lambda a: a + jnp.asarray(
        0.05 * np.abs(rng.normal(size=a.shape)).astype(np.float32)),
        j_empty(jcfg))
    np_tree = lambda t: jax.tree.map(np.asarray, t)
    return (jbundle, params, bn, build_tcn_bundle(cfg, "cpu"),
            params_from_jax(np_tree(params), "cpu"),
            params_from_jax(np_tree(bn), "cpu"))


def svc(*, ref: bool = False, paged: bool = True, **kw):
    """tests/test_chaos.py's ``_tcn`` service (2 slots, 2 tenants, 5 ways,
    paged in blocks of 2 ways): the port's, or the reference's (``ref``)."""
    jbundle, params, bn, bundle, p, bnt = setup()
    kw = {"n_slots": 2, "max_tenants": 2, "max_ways": 5, "fused": True,
          "paged_bank": paged, "bank_block_ways": 2, **kw}
    if ref:
        return JService(jbundle, params, bn, kernel_backend="ref", **kw)
    return StreamSessionService(bundle, p, bnt, **kw)


def close(got, want):
    """fp32 port against reference: the same -inf pattern, the rest
    allclose at RTOL, ATOL."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    live = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), live)
    np.testing.assert_array_equal(got[~live], want[~live])
    np.testing.assert_allclose(got[live], want[live], rtol=RTOL, atol=ATOL)


def same_result(a: dict, b: dict, *, exact: bool) -> None:
    """Two push results: bit for bit (``exact``), or port vs reference."""
    for key in ("emb", "logits", "tenant_logits"):
        if a[key] is None or b[key] is None:
            assert a[key] is None and b[key] is None, key
        elif exact:
            np.testing.assert_array_equal(a[key], b[key])
        else:
            close(a[key], b[key])
    if exact:
        assert a["pred"] == b["pred"] and a["step"] == b["step"]


def grids_equal(a: dict, b: dict) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(grids_equal(a[k], b[k])
                                            for k in a)
    return torch.equal(a, b)
