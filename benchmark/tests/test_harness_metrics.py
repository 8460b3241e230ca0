"""The metric arithmetic from a synthetic trace and synthetic records: the
rate over whole jobs and over all calls, the idle share, span attribution
by correlation, and the emission roofline."""

import types

import pytest

from benchmark.harness import stats, tracing, work
from benchmark.harness.spec import load_metric


def host(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur}


def launch(ts, corr):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
            "ts": ts, "dur": 1, "args": {"correlation": corr}}


def dev(cat, name, ts, dur, corr, device=0):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "args": {"correlation": corr, "device": device}}


def job_trace():
    """Two jobs of 1000 us.  Job 1: a wait 0-300, update_packed 300-400
    (kernel 10 us, copy 5 us), consolidate inside update_packed 350-390
    (kernel 20 us), save 600-900 holding a consolidate 650-700 (kernel 30
    us).  Job 2 (1000-2000): update_packed 1100-1200 (kernel 10 us), save
    1500-1800; and one kernel whose launch the trace lacks."""
    return tracing.Trace([
        host("job", 0, 1000), host("job", 1000, 1000),
        host("ingest_wait", 0, 300), host("ingest_wait", 1000, 50),
        host("update_packed", 300, 100), host("consolidate", 350, 40),
        host("save", 600, 300), host("consolidate", 650, 50),
        host("update_packed", 1100, 100), host("save", 1500, 300),
        launch(310, 1), dev("kernel", "k1", 320, 10, 1),
        launch(312, 2), dev("gpu_memcpy", "HtoD", 335, 5, 2),
        launch(360, 3), dev("kernel", "merge", 370, 20, 3),
        launch(660, 4), dev("kernel", "merge", 700, 30, 4),
        launch(1110, 5), dev("kernel", "k1", 1120, 10, 5),
        dev("kernel", "orphan", 1900, 40, 99),
        {"ph": "i", "cat": "kernel", "name": "instant", "ts": 5},
    ])


def run_of(trace=None, units=(), work=None, config=None, hbm=None,
           devices=(0,)):
    ctx = types.SimpleNamespace(cuda_devices=lambda: list(devices))
    return types.SimpleNamespace(
        trace=trace, units=list(units), work=work or {},
        config=config or {}, hbm_bytes_per_s=hbm, ctx=ctx, setup_s=3.5,
        peak_bytes=3 * 2 ** 20)


def test_attribution_by_correlation():
    t = job_trace()
    assert t.unmatched == 1
    assert t.device_time("update_packed", cats=("kernel",)) == 40
    assert t.device_time("update_packed", outside="consolidate",
                         cats=("kernel",)) == 20
    assert t.device_time("update_packed", outside="consolidate") == 25
    assert t.device_time("consolidate", cats=("kernel",)) == 50
    assert t.device_count("job", ("kernel",)) == 4


@pytest.mark.parametrize("name, want", [
    ("emit_device_ms.count", 20 / 1e3 / 2),
    ("consolidate_device_ms.count", 50 / 1e3 / 2),
    ("save_ms.count", (600 - 50) / 1e3 / 2),
    ("ingest_wait_pct.count", 100 * 350 / 2000),
    ("device_idle_pct.count", 100 * (1 - 115 / 2000)),
])
def test_count_readers(name, want):
    got = load_metric(name).read(run_of(job_trace()))
    assert got == pytest.approx(want)


def test_readers_without_a_trace_return_nothing():
    for name in ("emit_device_ms.count", "consolidate_device_ms.count",
                 "save_ms.count", "ingest_wait_pct.count",
                 "device_idle_pct.count", "emit_roofline.count",
                 "lookup_device_ms.lookup", "lookup_kernels_per_call.lookup",
                 "device_idle_pct.lookup"):
        assert load_metric(name).read(run_of()) is None
        assert load_metric(name).read(run_of(tracing.Trace([]))) is None


def test_emission_roofline():
    """2 update_packed calls of [4, 64] lanes at k = 31: 512 lanes x
    8.375 B at 1e9 B/s is 4.288 us, over 20 us of emission kernels."""
    cfg = dict(batch=4, length=64, k=31)
    got = load_metric("emit_roofline.count").read(
        run_of(job_trace(), config=cfg, hbm=1e9))
    assert got == pytest.approx(100 * 512 * 8.375 / 1e9 * 1e6 / 20)
    cfg["k"] = 63
    got = load_metric("emit_roofline.count").read(
        run_of(job_trace(), config=cfg, hbm=1e9))
    assert got == pytest.approx(100 * 512 * 16.375 / 1e9 * 1e6 / 20)
    assert load_metric("emit_roofline.count").read(
        run_of(job_trace(), config=dict(cfg, k=32), hbm=1e9)) is None
    assert load_metric("emit_roofline.count").read(
        run_of(job_trace(), config=cfg, hbm=None)) is None


def test_work_model():
    assert work.emission_bytes(245, 4096, 256, 31) == 245 * 4096 * 256 * 8.375
    assert work.emission_bytes_per_lane(63) == 16.375
    assert work.emission_bytes_per_lane(64) is None


def call_trace():
    """Three calls of 100 us; each launches two kernels (8 us, 2 us) and
    one copy (5 us) inside; a kernel launched between calls is not a
    call's."""
    events = []
    for i in range(3):
        t0 = 1000 * i
        events += [host("lookup_call", t0, 100),
                   launch(t0 + 10, 10 * i + 1),
                   dev("kernel", "search", t0 + 20, 8, 10 * i + 1),
                   launch(t0 + 12, 10 * i + 2),
                   dev("kernel", "scatter", t0 + 30, 2, 10 * i + 2),
                   launch(t0 + 14, 10 * i + 3),
                   dev("gpu_memcpy", "DtoH", t0 + 40, 5, 10 * i + 3)]
    events += [launch(500, 77), dev("kernel", "between", 500, 50, 77)]
    return tracing.Trace(events)


@pytest.mark.parametrize("name, want", [
    ("lookup_device_ms.lookup", 15 / 1e3),
    ("lookup_kernels_per_call.lookup", 2),
    ("device_idle_pct.lookup", 100 * (1 - 45 / 300)),
])
def test_lookup_readers(name, want):
    assert load_metric(name).read(run_of(call_trace())) == pytest.approx(want)


def test_idle_share_is_the_mean_over_devices():
    t = tracing.Trace([host("job", 0, 100),
                       dev("kernel", "a", 0, 50, 1, device=0),
                       dev("kernel", "b", 10, 10, 2, device=1),
                       dev("kernel", "c", 15, 10, 3, device=1)])
    got = load_metric("device_idle_pct.count").read(
        run_of(t, devices=(0, 1)))
    assert got == pytest.approx(100 * (1 - (50 + 15) / 2 / 100))


def test_rate_over_whole_jobs():
    jobs = [dict(start=10.0, end=11.5, rc=0), dict(start=11.6, end=13.0, rc=0),
            dict(start=13.0, end=15.0, rc=0)]
    got = load_metric("kmers_per_s.count").read(
        run_of(units=jobs, work=dict(kmers_per_job=1000)))
    assert got == pytest.approx(3000 / 5.0)
    jobs[1]["rc"] = 3
    got = load_metric("kmers_per_s.count").read(
        run_of(units=jobs, work=dict(kmers_per_job=1000)))
    assert got == pytest.approx(2000 / 5.0)


def test_lookup_rate_over_all_calls():
    calls, t = [], 0.0
    for i in range(106):
        wall = (1.0 + 0.01 * i) / 1e3
        calls.append(dict(start=t, end=t + wall, pool=i % 2))
        t += wall + 1e-4
    run = run_of(units=calls, work=dict(valid_lanes=[100, 50]))
    assert load_metric("lookup_queries_per_s").read(run) == pytest.approx(
        (53 * 100 + 53 * 50) / (calls[-1]["end"] - calls[0]["start"]))


def test_setup_and_peak_memory():
    run = run_of()
    assert load_metric("setup_s").read(run) == 3.5
    assert load_metric("peak_mem_mib").read(run) == 3.0


def test_spread_and_rate():
    assert stats.spread([1, 2, 3, 4, 5, 6, 7]) == pytest.approx(
        (6 - 2) / 4)
    assert stats.rate(10, 1.0, 3.0) == 5.0


def test_top_ops_and_idle_gaps():
    t = job_trace()
    window = tracing.Intervals([(0, 2000)])
    ops = dict(t.top_device_ops(window))
    assert ops["merge"] == pytest.approx(50 / 1e6)
    gaps = dict(t.idle_gaps(window))
    assert sum(gaps.values()) == pytest.approx((2000 - 115) / 1e6)
    assert gaps["ingest_wait"] == pytest.approx((300 + 50) / 1e6, rel=0.2)
