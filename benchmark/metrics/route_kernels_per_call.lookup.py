"""Device kernels launched a call in routing (a count, which repeats
exactly from call to call): kernel events whose launch lies inside the
program's ``kmers.lookup.route`` span, over the calls; a part of
``lookup_kernels_per_call.lookup``.

Spans: ``kmers.lookup.route``, the program's; ``lookup_call``, the
harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("lookup_call") \
            or not t.span_list("kmers.lookup.route"):
        return None
    n = t.device_count("kmers.lookup.route", ("kernel",))
    return n / len(t.span_list("lookup_call")) if n else None
