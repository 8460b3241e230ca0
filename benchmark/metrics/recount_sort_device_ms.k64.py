"""Device kernel time (ms) a job spends in the k = 64 re-counts' sort:
kernels launched inside the program's ``kmers.consolidate.recount.sort``
spans (the stable sorts by the two words and the invalid flag in
``count._count_weighted``), over the jobs; a part of
``recount_device_ms.k64``.

Spans: ``kmers.consolidate.recount.sort``, the program's; ``job``, the
harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not t.span_list("kmers.consolidate.recount.sort"):
        return None
    us = t.device_time("kmers.consolidate.recount.sort", cats=("kernel",))
    return us / 1e3 / len(t.span_list("job")) if us else None
