"""The readback staging buffer (utils/host.StagingBuffer) and the TCN
service's staged readback, with pinning off (a CPU buffer): the views'
shapes and offsets, growth only when a larger copy arrives, the
allocations in the service's registry, the same bits as the direct
readback, and no returned array aliasing the buffer.  The page-locked
buffer on a card: tests/test_torch_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import build_tcn_bundle  # noqa: E402
from repro_torch.obs import Tracer  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.sessions import StreamSessionService  # noqa: E402
from repro_torch.utils.host import StagingBuffer  # noqa: E402

F32 = torch.float32
SMALL = dict(tcn_channels=(8, 8), tcn_kernel=3, tcn_in_channels=2,
             embed_dim=12, n_classes=4)
KEYS = ("emb", "logits", "tenant_logits")


def test_views_lie_back_to_back_at_aligned_offsets():
    st = StagingBuffer(pinned=False)
    specs = [((3, 5, 12), F32), ((3, 5, 4), F32), ((3, 5, 7), F32)]
    offsets, total = StagingBuffer.layout(specs)
    assert StagingBuffer.ALIGN == 256
    # 720 bytes, then 240, then 420, each from a multiple of 256
    assert offsets == [0, 768, 1024] and total == 1444
    views = st.views(specs)
    assert [tuple(v.shape) for v in views] == [s for s, _ in specs]
    assert all(v.dtype == F32 and v.is_contiguous()
               and v.device.type == "cpu" for v in views)
    base = st._buf.data_ptr()
    assert [v.data_ptr() - base for v in views] == offsets
    # the power of two at or above, as the caching host allocator rounds
    assert st.nbytes == st._buf.numel() == 2048
    assert st.allocs == 1 and not st.pinned
    # mixed dtypes, and a view of no elements
    specs = [((2, 3), torch.int32), ((0, 4), F32), ((5,), torch.uint8)]
    assert StagingBuffer.layout(specs) == ([0, 256, 256], 261)
    assert [v.dtype for v in st.views(specs)] == [s[1] for s in specs]
    assert st.allocs == 1  # 261 bytes fit in the 2048 held
    st.views([((512,), F32)])  # exactly 2048 bytes: still no growth
    assert st.allocs == 1 and st.nbytes == 2048


def test_buffer_grows_only_for_a_larger_copy():
    reg = MetricsRegistry()
    st = StagingBuffer(False, nbytes_gauge=reg.gauge("held"),
                       allocs_counter=reg.counter("allocs"))
    read = lambda name: reg.snapshot()[name][0]["value"]
    small = [torch.ones(4, 6), torch.ones(4, 2)]
    for _ in range(3):
        st.fill(small)
    ptr, held = st._buf.data_ptr(), st.nbytes
    assert st.allocs == 1 and held == 512  # 96 + 32 bytes at 0 and 256
    st.fill([torch.ones(2, 6)])  # fewer bytes: the same buffer
    assert st.allocs == 1 and st._buf.data_ptr() == ptr
    big = [torch.ones(40, 6), torch.ones(40, 2)]
    st.fill(big)
    st.fill(big)
    st.fill(small)
    assert st.allocs == 2 and st.nbytes == 2048  # 960 + 320 at 0 and 1024
    assert read("allocs") == 2 and read("held") == st.nbytes
    st.release()
    assert st.nbytes == 0 and read("held") == 0 and read("allocs") == 2


def test_fill_copies_values_into_the_buffer_contiguously():
    st = StagingBuffer(pinned=False)
    x = torch.arange(2 * 3 * 8, dtype=F32).reshape(2, 3, 8)
    y = x[..., :5]  # a slice, as the paged table's first max_ways columns
    z = torch.arange(6, dtype=torch.int32)
    a, b, c = st.fill([x, y, z])
    np.testing.assert_array_equal(a, x.numpy())
    np.testing.assert_array_equal(b, y.numpy())
    np.testing.assert_array_equal(c, z.numpy())
    assert b.flags.c_contiguous and c.dtype == np.int32
    buf = st._buf.numpy()
    assert all(np.shares_memory(h, buf) for h in (a, b, c))
    x += 1  # copies, not views of the sources
    assert a[0, 0, 0] == 0 and b[0, 0, 0] == 0


def _svc(*, staged: bool, paged: bool, t_chunk: int, tracer=None):
    cfg = get_config("chameleon-tcn").replace(**SMALL)
    bundle = build_tcn_bundle(cfg, "cpu")
    params = bundle.init(torch.Generator().manual_seed(0))
    params["fc"]["w"] = torch.randn(  # the head starts at zero
        params["fc"]["w"].shape, generator=torch.Generator().manual_seed(1))
    s = StreamSessionService(bundle, params, n_slots=3, max_tenants=2,
                             max_ways=5, paged_bank=paged,
                             bank_block_ways=2, t_chunk=t_chunk,
                             tracer=tracer)
    if staged:
        s._stage_readback(pinned=False)
    return s


def _drive(s, seed):
    """Three streams, two of them with a tenant that has enrolled: pushes of
    11 steps, of 3 and of a single sample."""
    rng = np.random.default_rng(seed)
    sids = [s.open_session(tenant=None), s.open_session(tenant=None),
            s.open_session()]
    for sid in sids[:2]:
        s.enroll_shots(sid, rng.normal(size=(2, 6, 2)).astype(np.float32))
    x = rng.normal(size=(3, 11, 2)).astype(np.float32)
    return [s.push_audio({sid: x[i] for i, sid in enumerate(sids)}),
            s.push_audio({sids[1]: x[1, :3], sids[2]: x[2, 3:6]}),
            s.push_audio({sids[0]: x[0, 0]})]


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
@pytest.mark.parametrize("t_chunk", [8, 16], ids=["ticks", "one_tick"])
def test_staged_readback_returns_the_direct_readbacks_bits(paged, t_chunk):
    """The same results through the staging buffer as through the direct
    readback, with a paged table wider than max_ways (its slice copied
    contiguously) and a push of two ticks (8 and 4 steps); one allocation
    (the 4-step tick fits in the 8-step one's bytes), in the registry."""
    tracers = [Tracer(enabled=True), Tracer(enabled=True)]
    svcs = [_svc(staged=staged, paged=paged, t_chunk=t_chunk, tracer=t)
            for staged, t in zip((False, True), tracers)]
    runs = [_drive(s, 3) for s in svcs]
    for direct, staged in zip(*runs):
        assert direct.keys() == staged.keys()
        for a, b in zip(direct.values(), staged.values()):
            for key in KEYS:
                assert (a[key] is None) == (b[key] is None), key
                if a[key] is not None:
                    np.testing.assert_array_equal(a[key], b[key])
            assert a["pred"] == b["pred"] and a["step"] == b["step"]
    assert runs[0][0][0]["tenant_logits"].shape == (11, 5)
    direct, staged = svcs
    assert direct._staging is None
    assert "readback_staging_bytes" not in direct.metrics()
    m = staged.metrics()
    assert m["readback_staging_allocs_total"][0]["value"] == 1
    assert m["readback_staging_bytes"][0]["value"] == staged._staging.nbytes
    for t in tracers:  # a CPU buffer is never page-locked
        spans = [e for e in t.events() if e["name"] == "readback"]
        assert len(spans) == staged.dispatches
        assert all(e["args"]["pinned"] is False for e in spans)
    assert [e["args"]["bytes"] for e in tracers[0].events()
            if e["name"] == "readback"] == \
        [e["args"]["bytes"] for e in tracers[1].events()
         if e["name"] == "readback"]


@pytest.mark.parametrize("t_chunk", [8, 16], ids=["ticks", "one_tick"])
def test_a_push_keeps_its_results_after_the_next_push(t_chunk):
    s = _svc(staged=True, paged=True, t_chunk=t_chunk)
    first = _drive(s, 4)[0]
    kept = {sid: {k: None if r[k] is None else r[k].copy() for k in KEYS}
            for sid, r in first.items()}
    rng = np.random.default_rng(5)
    later = s.push_audio({sid: rng.normal(size=(11, 2)).astype(np.float32)
                          for sid in first})
    buf = s._staging._buf.numpy()
    for sid, r in first.items():
        for key in KEYS:
            if r[key] is not None:
                np.testing.assert_array_equal(r[key], kept[sid][key])
                assert not np.array_equal(r[key], later[sid][key])
                for res in (r, later[sid]):
                    assert not np.shares_memory(res[key], buf), key
    assert s.metrics()["readback_staging_allocs_total"][0]["value"] == 1
