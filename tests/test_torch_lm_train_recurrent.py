"""LM training of the recurrent families (rwkv6-1.6b, the zamba2-1.2b
hybrid) in the port against the JAX reference, on the CPU: ``loss_fn``
and its gradients at ``smoke()`` against ``jax.value_and_grad`` in fp32
and bf16 (the tolerances and helpers of ``test_torch_lm_train.py``), and
remat (each RWKV layer, each Mamba layer and each application of zamba's
shared block checkpointed as a unit) against the plain forward, bit for
bit."""

import pytest

torch = pytest.importorskip("torch")

from test_torch_lm_train import (  # noqa: E402
    _one_torch_thread,  # noqa: F401  (the module's one-thread fixture)
    _remat_batch,
    check_bf16,
    check_fp32,
)

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_bundle  # noqa: E402
from repro_torch.models.build import (  # noqa: E402
    _rwkv_forward,
    _zamba_forward,
)
from repro_torch.models.rwkv import rwkv_empty_cache  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    chunked_cross_entropy,
    embed_tokens,
)
from repro_torch.training import value_and_grad  # noqa: E402
from repro_torch.utils.trees import tree_leaves  # noqa: E402

ARCHS = ["rwkv6-1.6b", "zamba2-1.2b"]


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference_fp32(name):
    check_fp32(name)


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grads_match_reference_bf16(name):
    check_bf16(name)


def _plain_loss(cfg):
    def loss_fn(params, batch):
        x = embed_tokens(params, cfg, batch["tokens"])
        if cfg.family == "rwkv":
            h, _ = _rwkv_forward(params, cfg, x, rwkv_empty_cache(
                cfg, x.shape[0], x.dtype, "cpu"))
        else:
            h, _ = _zamba_forward(params, cfg, x, None, 0)
        return chunked_cross_entropy(h, params["lm_head"], batch["labels"],
                                     cfg.logit_chunk)

    return loss_fn


@pytest.mark.parametrize("name", ARCHS)
def test_remat_gives_the_same_loss_and_gradients(name):
    cfg = get_config(name).smoke().replace(n_layers=4)
    b = build_bundle(cfg, "cpu")
    params = b.init(torch.Generator().manual_seed(0))
    batch = _remat_batch(cfg)
    want = value_and_grad(_plain_loss(cfg), params, batch)
    got = value_and_grad(b.loss_fn, params, batch)
    assert torch.equal(got[0], want[0])
    assert all(torch.equal(a, c) for a, c in zip(tree_leaves(got[2]),
                                                 tree_leaves(want[2])))
    assert set(got[1]) == {"acc", "tokens"}
