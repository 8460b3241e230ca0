"""Device kernels launched a batch in routing (a count, which repeats
exactly from run to run): kernel events whose launch lies inside the
program's ``kmers.route.bucket`` or ``kmers.route.unmix`` spans, over
the batches (the program's ``kmers.emit`` spans, one a batch): the
eager launches of the Feistel mix, the owner sort and the send buffers.

Spans: ``kmers.route.bucket``, ``kmers.route.unmix``, ``kmers.emit``,
the program's."""

SPANS = {}
ROUTING = ("kmers.route.bucket", "kmers.route.unmix")


def read(run):
    t = run.trace
    if t is None or not t.span_list("kmers.emit"):
        return None
    n = sum(t.device_count(s, ("kernel",)) for s in ROUTING)
    return n / len(t.span_list("kmers.emit")) if n else None
