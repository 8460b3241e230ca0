"""Device time (ms) a call: every kernel, copy and memset launched inside
a call (``route.route_queries``, ``count.lookup`` and the copies home,
through ``pipeline.make_sharded_lookup``'s step), over the calls.

Spans: ``lookup_call``, the harness's span around each call."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("lookup_call"):
        return None
    us = t.device_time("lookup_call")
    return us / 1e3 / len(t.span_list("lookup_call")) if us else None
