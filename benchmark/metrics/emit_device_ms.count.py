"""Device kernel time (ms) a job spends on emission: kernels launched
inside ``update_packed`` and not inside ``_consolidate`` (the windows,
the unit tables and their metrics, per batch).

Spans: ``update_packed``, calls of
``kmers_tpu_torch.parallel.stream.StreamingCounter.update_packed``;
``consolidate``, calls of its ``_consolidate``; ``job``, the harness's
span around each CLI job."""

STREAM = "kmers_tpu_torch.parallel.stream"
SPANS = {
    "update_packed": [f"{STREAM}:StreamingCounter.update_packed"],
    "consolidate": [f"{STREAM}:StreamingCounter._consolidate"],
}


def read(run):
    t = run.trace
    if t is None or not t.span_list("job") or not t.span_list("update_packed"):
        return None
    us = t.device_time("update_packed", outside="consolidate",
                       cats=("kernel",))
    return us / 1e3 / len(t.span_list("job")) if us else None
