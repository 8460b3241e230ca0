"""Device kernel time (ms) a job spends sorting the pending unit keys at
consolidation: kernels launched inside the program's
``kmers.consolidate.sort`` spans (``_sort_units``, ``_sort_units_wide``),
over the jobs; a part of ``consolidate_device_ms.count``.

Spans: ``kmers.consolidate.sort``, the program's; ``job``, the
harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not t.span_list("kmers.consolidate.sort"):
        return None
    us = t.device_time("kmers.consolidate.sort", cats=("kernel",))
    return us / 1e3 / len(t.span_list("job")) if us else None
