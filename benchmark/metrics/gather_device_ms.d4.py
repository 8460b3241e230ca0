"""Device time (ms) a job spends gathering the shard tables to the
table's card: each copy, kernel and memset launched inside the
program's ``kmers.consolidate.gather`` spans
(``pipeline.gather_tables`` in ``ShardedStreamingCounter._consolidate``),
over the jobs.

Spans: ``kmers.consolidate.gather``, the program's; ``job``, the
harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not t.span_list("kmers.consolidate.gather"):
        return None
    us = t.device_time("kmers.consolidate.gather")
    return us / 1e3 / len(t.span_list("job")) if us else None
