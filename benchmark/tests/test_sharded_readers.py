"""The readers of the four-card cell's metrics (``*.d4``) over the
program's sharded spans and routing counters, from a synthetic trace of
two jobs on four cards and a synthetic counter snapshot; and the same
readers where the program records none of them, or the card has no
published link peak, where each leaves its metric out."""

import pytest

from benchmark.harness import links, tracing
from benchmark.harness.spec import load_metric
from benchmark.tests.test_harness_metrics import dev, host, launch, run_of

H100 = "NVIDIA H100 80GB HBM3"
#: PyTorch's kernels of a strided copy between cards and of a stack
COPY = ("void at::native::elementwise_kernel<128, 2, at::native::"
        "gpu_kernel_impl_nocast<at::native::direct_copy_kernel_cuda("
        "at::TensorIteratorBase&)::{lambda()#3}::operator()() const>")
STACK = "void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>"
#: the fullest receiver's bytes: 10 us at the H100's 450 GB/s
RECV_BYTES = 4_500_000


def sharded_trace():
    """Two jobs of 1000 us, one batch each (kmers.emit 100-300 and
    1100-1300).  Job 1: bucket 110-150 launches a kernel on card 0 (10
    us), one on card 1 (20 us) and a memset on card 2 (2 us); the
    exchange 160-180 launches copies on cards 1 and 2 at 170-190 and
    180-200 (a copy kernel and a memcpy; one 30 us union) and a stack
    kernel on card 0 (5 us, no copy between cards); unmix
    190-200 a kernel on card 3 (10 us); the gather 500-520 a copy (20
    us) and a kernel (10 us) on card 0.  Job 2: a bucket kernel (10 us),
    an exchange copy kernel 1170-1180 and an unmix kernel (10 us).  And one
    kernel launched outside every span."""
    return tracing.Trace([
        host("job", 0, 1000), host("job", 1000, 1000),
        host("kmers.emit", 100, 200), host("kmers.emit", 1100, 200),
        host("kmers.route.bucket", 110, 40),
        host("kmers.route.bucket", 1110, 40),
        host("kmers.route.exchange", 160, 20),
        host("kmers.route.exchange", 1160, 20),
        host("kmers.route.unmix", 190, 10),
        host("kmers.route.unmix", 1190, 10),
        host("kmers.consolidate.gather", 500, 20),
        launch(120, 1), dev("kernel", "mix", 130, 10, 1, 0),
        launch(125, 2), dev("kernel", "sort", 135, 20, 2, 1),
        launch(140, 3), dev("gpu_memset", "Memset", 150, 2, 3, 2),
        launch(165, 4), dev("kernel", COPY, 170, 20, 4, 1),
        launch(166, 5), dev("gpu_memcpy", "Memcpy PtoP", 180, 20, 5, 2),
        launch(168, 6), dev("kernel", STACK, 200, 5, 6, 0),
        launch(195, 7), dev("kernel", "unmix", 205, 10, 7, 3),
        launch(400, 30), dev("kernel", "outside", 410, 10, 30, 0),
        launch(510, 20), dev("gpu_memcpy", "Memcpy PtoP", 515, 20, 20, 0),
        launch(512, 21), dev("kernel", "stack", 540, 10, 21, 0),
        launch(1120, 11), dev("kernel", "mix", 1130, 10, 11, 0),
        launch(1165, 14), dev("kernel", COPY, 1170, 10, 14, 3),
        launch(1195, 17), dev("kernel", "unmix", 1200, 10, 17, 0),
    ])


def four_cards(trace):
    return run_of(trace, devices=(0, 1, 2, 3))


@pytest.fixture
def counters(monkeypatch):
    from kmers_tpu_torch import profiling

    snapshot = {"kmers.route.exchanges": 2,
                "kmers.route.recv_bytes_max": RECV_BYTES}
    monkeypatch.setattr(profiling, "counters", lambda: dict(snapshot))
    monkeypatch.setattr(links, "card_name", lambda run: H100)


@pytest.mark.parametrize("name, want", [
    ("shard_emit_host_ms.d4", (200 + 200) / 1e3 / 2),
    ("route_device_ms.d4", (10 + 20 + 2 + 10 + 10 + 10) / 1e3 / 2),
    ("route_kernels_per_batch.d4", 5 / 2),
    ("exchange_device_ms.d4", (20 + 20 + 5 + 10) / 1e3 / 2),
    # the least time, 10 us, over the union of the copies, 30 + 10 us
    ("exchange_link_pct.d4", 100 * 10 / 40),
    ("gather_device_ms.d4", (20 + 10) / 1e3 / 2),
])
def test_sharded_readers(counters, name, want):
    got = load_metric(name).read(four_cards(sharded_trace()))
    assert got == pytest.approx(want)


def test_link_peak_by_card_name():
    assert links.link_bytes_per_s(H100) == 450e9
    for kind in ("NVIDIA H100 PCIe", "NVIDIA A100-SXM4-80GB", "", None):
        assert links.link_bytes_per_s(kind) is None


@pytest.mark.parametrize("kind", ["NVIDIA A100-SXM4-80GB",
                                  "NVIDIA H100 PCIe", None])
def test_link_share_reads_nothing_for_an_unknown_card(counters, monkeypatch,
                                                      kind):
    monkeypatch.setattr(links, "card_name", lambda run: kind)
    reader = load_metric("exchange_link_pct.d4")
    assert reader.read(four_cards(sharded_trace())) is None


READERS = ("shard_emit_host_ms.d4", "route_device_ms.d4",
           "route_kernels_per_batch.d4", "exchange_device_ms.d4",
           "exchange_link_pct.d4", "gather_device_ms.d4")


@pytest.mark.parametrize("name", READERS)
def test_sharded_readers_without_spans_or_counters(monkeypatch, name):
    """Nothing without a trace, on an empty trace, on a trace of the
    harness's spans alone (a program that records no sharded span), and
    with no counters or a profiling module that keeps none."""
    from kmers_tpu_torch import profiling

    monkeypatch.setattr(links, "card_name", lambda run: H100)
    monkeypatch.setattr(profiling, "counters", dict, raising=False)
    reader = load_metric(name)
    harness_only = tracing.Trace([
        host("job", 0, 1000), host("update_packed", 300, 100),
        host("save", 600, 300), launch(310, 1),
        dev("gpu_memcpy", "Memcpy PtoP", 320, 10, 1)])
    for trace in (None, tracing.Trace([]), harness_only):
        assert reader.read(four_cards(trace)) is None
    monkeypatch.delattr(profiling, "counters")
    assert reader.read(four_cards(harness_only)) is None
    if name == "exchange_link_pct.d4":
        # the spans without the counter: no bytes to put over the time
        monkeypatch.setattr(profiling, "counters", dict, raising=False)
        assert reader.read(four_cards(sharded_trace())) is None
