"""Share of the k = 64 cell's job walls (%) in which no kernel, copy or
memset runs on the device.

Spans: ``job``, the harness's span around each whole CLI job."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.device or not t.span_list("job"):
        return None
    jobs = t.intervals("job")
    busy = t.busy(jobs, run.ctx.cuda_devices() or None)
    return 100.0 * (1.0 - busy / jobs.length)
