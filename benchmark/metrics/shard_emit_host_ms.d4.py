"""Host wall time (ms) a job spends in the sharded step: the program's
``kmers.emit`` spans around ``ShardedStreamingCounter.update`` /
``update_packed`` (the split, every shard's windows, routing and
exchange, the shard tables), over the jobs.  Nothing where the program
records no such span.

Spans: ``kmers.emit``, the program's; ``job``, the harness's span
around each CLI job."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") or not t.span_list("kmers.emit"):
        return None
    return t.intervals("kmers.emit").length / 1e3 / len(t.span_list("job"))
