"""Device kernel time (ms) a job spends joining the tables of the k = 64
re-counts: kernels launched inside the program's
``kmers.consolidate.recount.join`` spans (``count._merge_many``: each
table's four int32 planes joined into two int64 words, and the words,
validity and weights of every table concatenated), over the jobs; a part
of ``recount_device_ms.k64`` that a merge of the sorted tables would not
have.  Nothing on a program without the span.

Spans: ``kmers.consolidate.recount.join``, the program's; ``job``, the
harness's."""

SPANS = {}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") \
            or not t.span_list("kmers.consolidate.recount.join"):
        return None
    us = t.device_time("kmers.consolidate.recount.join", cats=("kernel",))
    return us / 1e3 / len(t.span_list("job")) if us else None
