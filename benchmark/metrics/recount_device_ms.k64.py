"""Device kernel time (ms) a job spends in the weighted re-counts that
consolidate the k = 64 run-length tables: kernels launched inside the
program's ``kmers.consolidate.recount`` spans (``count._merge_many``:
the tables' join into int64 words, their concatenation,
``_count_weighted``'s two-word sort, run starts, sums and compaction),
over the jobs.

Spans: ``kmers.consolidate.recount``, the program's; ``job``, the
harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not t.span_list("kmers.consolidate.recount"):
        return None
    us = t.device_time("kmers.consolidate.recount", cats=("kernel",))
    return us / 1e3 / len(t.span_list("job")) if us else None
