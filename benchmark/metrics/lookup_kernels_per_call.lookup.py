"""Device kernels launched a call (a count, which repeats exactly from
call to call): kernel events of the device trace whose launch lies inside
a call, over the calls.

Spans: ``lookup_call``, the harness's span around each call."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("lookup_call"):
        return None
    n = t.device_count("lookup_call", ("kernel",))
    return n / len(t.span_list("lookup_call")) if n else None
