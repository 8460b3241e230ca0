"""The exchange's share (%) of its link's peak: the least time the
exchange needs, the program's counter ``kmers.route.recv_bytes_max``
(the bytes that the fullest receiver took in from the other shards,
summed over the exchanges) at the link's published peak in one
direction (``benchmark/harness/links.py``), over the time the exchange's
copies between cards took: the length of the union, over every card, of
the copies launched inside ``kmers.route.exchange``.  A copy is a
memcpy, or PyTorch's copy kernel (``direct_copy_kernel_cuda``), which
moves a strided row block between cards that reach each other directly;
each receiver's stack of its rows (``CatArrayBatchedCopy``) stays on
its card and is left out.  A card takes in no faster than its link, so
the share stays under 100.

The counter and the spans cover the same traced window.  Nothing
without the counter or the copies, or on a card with no published
link peak.

Spans: ``kmers.route.exchange``, the program's."""

from benchmark.harness import links, tracing

SPANS = {}
COPY_KERNEL = "direct_copy_kernel"


def read(run):
    t = run.trace
    if t is None or not t.span_list("kmers.route.exchange"):
        return None
    from kmers_tpu_torch import profiling

    nbytes = getattr(profiling, "counters", dict)().get(
        "kmers.route.recv_bytes_max")
    peak = links.link_bytes_per_s(links.card_name(run))
    if not nbytes or not peak:
        return None
    inside = t.intervals("kmers.route.exchange")
    copies = tracing.Intervals(
        (a, b) for cat, name, a, b, _, launch in t.device
        if (cat == "gpu_memcpy" or COPY_KERNEL in name)
        and launch is not None and launch in inside)
    if not copies.length:
        return None
    return 100.0 * (nbytes / peak * 1e6) / copies.length
