"""Host wall time (ms) a job spends in emission: the program's own
``kmers.emit`` spans (``StreamingCounter.update`` / ``update_packed``
up to ``_absorb``: the batch's copies up and ``pipeline.count_reads*``'s
launches), over the jobs.

Spans: ``kmers.emit``, the program's; ``job``, the harness's span
around each CLI job."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") or not t.span_list("kmers.emit"):
        return None
    return t.intervals("kmers.emit").length / 1e3 / len(t.span_list("job"))
