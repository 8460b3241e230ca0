"""Host wall time (ms) a job spends inside ``save``, less its nested
``_consolidate``: turning the table into numpy arrays and writing the
.npz.

Spans: ``save``, calls of
``kmers_tpu_torch.parallel.stream.StreamingCounter.save``;
``consolidate``, as ``consolidate_device_ms.count``'s; ``job``, the
harness's span."""

STREAM = "kmers_tpu_torch.parallel.stream"
SPANS = {"save": [f"{STREAM}:StreamingCounter.save"],
         "consolidate": [f"{STREAM}:StreamingCounter._consolidate"]}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") or not t.span_list("save"):
        return None
    save = t.intervals("save")
    own = save.length - save.overlap(t.intervals("consolidate"))
    return own / 1e3 / len(t.span_list("job"))
