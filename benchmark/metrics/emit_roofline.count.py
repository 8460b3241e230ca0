"""Emission's share (%) of its roofline: the least time the emission
work needs at the card's published peak HBM bandwidth, over the kernel
time that emission took (``emit_device_ms.count``'s).  The work
(``benchmark/harness/work.py``): every lane of every batch, batches x
batch x length, reads 0.375 B of packed input and writes its key, 8 B
at k <= 31 and 16 B at 33 <= k <= 63; batches are the ``update_packed``
calls.  Nothing where the card's peak or the k's key width is not known.

Spans: as ``emit_device_ms.count``."""

from benchmark.harness.work import emission_bytes

STREAM = "kmers_tpu_torch.parallel.stream"
SPANS = {
    "update_packed": [f"{STREAM}:StreamingCounter.update_packed"],
    "consolidate": [f"{STREAM}:StreamingCounter._consolidate"],
}


def read(run):
    t, c = run.trace, run.config
    if t is None or not run.hbm_bytes_per_s:
        return None
    batches = len(t.span_list("update_packed"))
    nbytes = emission_bytes(batches, c["batch"], c["length"], c["k"])
    us = t.device_time("update_packed", outside="consolidate",
                       cats=("kernel",))
    if not nbytes or not us:
        return None
    return 100.0 * (nbytes / run.hbm_bytes_per_s * 1e6) / us
