"""Device kernel time (ms) a job spends building the per-batch run-length
tables of 128-bit keys at k = 64 (no spare key bit): kernels launched
inside the program's ``kmers.emit.runs`` spans (``count._count_words``'
two-word stable sorts and ``_count_sorted_runs``, inside
``kmers.emit.count``), over the jobs.

Spans: ``kmers.emit.runs``, the program's; ``job``, the harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not t.span_list("kmers.emit.runs"):
        return None
    us = t.device_time("kmers.emit.runs", cats=("kernel",))
    return us / 1e3 / len(t.span_list("job")) if us else None
