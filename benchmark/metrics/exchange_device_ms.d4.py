"""Device time (ms) a job spends in the exchange, over every card: each
copy, kernel and memset launched inside the program's
``kmers.route.exchange`` spans (one ``mesh.all_to_all`` a routing pass:
on one process the copies between the cards and each receiver's stack),
over the jobs.

Spans: ``kmers.route.exchange``, the program's; ``job``, the
harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not t.span_list("kmers.route.exchange"):
        return None
    us = t.device_time("kmers.route.exchange")
    return us / 1e3 / len(t.span_list("job")) if us else None
