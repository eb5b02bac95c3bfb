"""LM training of the MoE family (deepseek-v2-lite-16b with MLA,
moonshot-v1-16b-a3b with GQA) in the port against the JAX reference, on
the CPU: ``loss_fn`` and its gradients at ``smoke()`` against
``jax.value_and_grad`` in fp32 and bf16 (the tolerances and helpers of
``test_torch_lm_train.py``), and the router's aux term in the loss."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_train import (  # noqa: E402
    _one_torch_thread,  # noqa: F401  (the module's one-thread fixture)
    check_bf16,
    check_fp32,
    close32,
    reference,
)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_jax  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models.build import _lm_inputs  # noqa: E402

ARCHS = ["deepseek-v2-lite-16b", "moonshot-v1-16b-a3b"]


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference_fp32(name):
    check_fp32(name)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference_bf16(name):
    check_bf16(name)


def test_moe_loss_adds_the_router_aux_term():
    """The MoE stack's loss is the cross-entropy plus router_aux_coef x
    moe_aux, its metrics carry moe_aux and moe_dropped, as the reference's
    (``src/repro/models/build.py:179-186``)."""
    name = "deepseek-v2-lite-16b"
    params, batch, loss, metrics, _ = reference(name, "float32")
    cfg = get_config(name).smoke().replace(act_dtype="float32")
    b = build_bundle(cfg, "cpu")
    p = params_from_jax(params, "cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got, m = b.loss_fn(p, tb)
        x, labels, _ = _lm_inputs(p, cfg, tb)
        h, _ = tt.backbone(p, cfg, x, 0, None)
        ce, _ = tt.chunked_cross_entropy(h, p["lm_head"], labels,
                                         cfg.logit_chunk)
    assert float(m["moe_aux"]) > 0 and cfg.router_aux_coef > 0
    torch.testing.assert_close(got, ce + cfg.router_aux_coef * m["moe_aux"],
                               rtol=0, atol=0)
    close32(got, loss)
