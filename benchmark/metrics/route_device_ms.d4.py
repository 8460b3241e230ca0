"""Device time (ms) a job spends routing, over every card: each kernel,
copy and memset launched inside the program's ``kmers.route.bucket``
(the senders' Feistel mix, owner sort and send buffers) and
``kmers.route.unmix`` (the receivers' Feistel unmix) spans, over the
jobs.

Spans: ``kmers.route.bucket``, ``kmers.route.unmix``, the program's;
``job``, the harness's."""

SPANS = {}
ROUTING = ("kmers.route.bucket", "kmers.route.unmix")


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not any(t.span_list(s) for s in ROUTING):
        return None
    us = sum(t.device_time(s) for s in ROUTING)
    return us / 1e3 / len(t.span_list("job")) if us else None
