"""Share of the call walls (%) in which no kernel, copy or memset runs on
the device.

Spans: ``lookup_call``, the harness's span around each call, from its
start until its answers are on the host."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.device or not t.span_list("lookup_call"):
        return None
    calls = t.intervals("lookup_call")
    busy = t.busy(calls, run.ctx.cuda_devices() or None)
    return 100.0 * (1.0 - busy / calls.length)
