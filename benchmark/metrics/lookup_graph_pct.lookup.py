"""Share (%) of the lookup steps answered by replaying their CUDA graphs:
the program's counters ``kmers.lookup.replays`` over
``kmers.lookup.calls``, as ``ingest_ready_pct.count``'s.  100, the host
launches three graphs a call instead of every routing op.

Spans: none (counters of the program's own)."""

SPANS = {}


def read(run):
    from kmers_tpu_torch import profiling

    c = getattr(profiling, "counters", dict)()
    calls, replays = c.get("kmers.lookup.calls"), c.get("kmers.lookup.replays")
    if not calls or replays is None:
        return None
    return 100.0 * replays / calls
