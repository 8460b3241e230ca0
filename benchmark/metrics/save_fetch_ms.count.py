"""Host wall time (ms) a job spends copying the table home to save it:
the program's ``kmers.save.fetch`` spans (``convert.table_to_numpy``
inside ``StreamingCounter.save``), over the jobs; a part of
``save_ms.count``.

Spans: ``kmers.save.fetch``, the program's; ``job``, the harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not t.span_list("kmers.save.fetch"):
        return None
    fetch = t.intervals("kmers.save.fetch")
    return fetch.length / 1e3 / len(t.span_list("job"))
