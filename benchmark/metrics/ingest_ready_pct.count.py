"""Share (%) of the batches the stream loop took from
``io.fastx.prefetch``'s queue that were queued before it asked: the
program's counters ``kmers.ingest.ready`` over ``kmers.ingest.batches``,
as ``parse_ms.count``'s.  High, the parser runs ahead of the loop.

Spans: none (counters of the program's own)."""

SPANS = {}


def read(run):
    from kmers_tpu_torch import profiling

    c = getattr(profiling, "counters", dict)()
    batches, ready = c.get("kmers.ingest.batches"), c.get("kmers.ingest.ready")
    if not batches or ready is None:
        return None
    return 100.0 * ready / batches
