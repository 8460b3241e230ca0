"""Device kernel time (ms) a job spends consolidating: kernels launched
inside ``_consolidate`` (the pending keys' sort, the merge and compress
kernels K3 / K6 and K4, eviction), wherever it is called from (a full
pending list, or ``save``).

Spans: ``consolidate``, calls of
``kmers_tpu_torch.parallel.stream.StreamingCounter._consolidate``;
``job``, the harness's span."""

STREAM = "kmers_tpu_torch.parallel.stream"
SPANS = {"consolidate": [f"{STREAM}:StreamingCounter._consolidate"]}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") or not t.span_list("consolidate"):
        return None
    us = t.device_time("consolidate", cats=("kernel",))
    return us / 1e3 / len(t.span_list("job")) if us else None
