"""Host wall time (ms) a job spends writing the saved table: the
program's ``kmers.save.write`` spans (``np.savez`` of the temp file and
``os.replace`` inside ``StreamingCounter.save``), over the jobs; a part
of ``save_ms.count``.

Spans: ``kmers.save.write``, the program's; ``job``, the harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not t.span_list("kmers.save.write"):
        return None
    write = t.intervals("kmers.save.write")
    return write.length / 1e3 / len(t.span_list("job"))
