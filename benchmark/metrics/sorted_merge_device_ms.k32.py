"""Device kernel time (ms) a job spends merging sorted tables into the
table: kernels launched inside the program's
``kmers.consolidate.sorted_merge`` spans (``count.merge_sorted_tables``:
the pending tables' live lanes, their weighted merges, the merge with
the table's live prefix, the run reduction), over the jobs.  Nothing on
a program without the span.

Spans: ``kmers.consolidate.sorted_merge``, the program's; ``job``, the
harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not t.span_list("kmers.consolidate.sorted_merge"):
        return None
    us = t.device_time("kmers.consolidate.sorted_merge", cats=("kernel",))
    return us / 1e3 / len(t.span_list("job")) if us else None
