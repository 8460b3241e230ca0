"""Device time (ms) a call spends routing the queries: every kernel,
copy and memset launched inside the program's ``kmers.lookup.route``
span (``pipeline.make_sharded_lookup``'s step: ``batch_sharding`` and
``route.route_queries``), over the calls; a part of
``lookup_device_ms.lookup``.

Spans: ``kmers.lookup.route``, the program's; ``lookup_call``, the
harness's span around each call."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("lookup_call") \
            or not t.span_list("kmers.lookup.route"):
        return None
    us = t.device_time("kmers.lookup.route")
    return us / 1e3 / len(t.span_list("lookup_call")) if us else None
