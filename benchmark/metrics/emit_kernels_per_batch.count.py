"""Device kernels launched a batch in emission (a count, which repeats
exactly from run to run): kernel events whose launch lies inside one of
the program's ``kmers.emit`` spans, over those spans (one a batch).

Spans: ``kmers.emit``, the program's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("kmers.emit"):
        return None
    n = t.device_count("kmers.emit", ("kernel",))
    return n / len(t.span_list("kmers.emit")) if n else None
