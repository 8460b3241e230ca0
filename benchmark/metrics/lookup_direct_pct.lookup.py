"""Share (%) of the lookup steps answered by the one-shard search kernel,
without routing: the program's counters ``kmers.lookup.direct`` over
``kmers.lookup.calls``, as ``lookup_graph_pct.lookup``'s.  100, every call
of a one-card mesh is one search kernel; nothing on a program that keeps
no such counter.

Spans: none (counters of the program's own)."""

SPANS = {}


def read(run):
    from kmers_tpu_torch import profiling

    c = getattr(profiling, "counters", dict)()
    calls, direct = c.get("kmers.lookup.calls"), c.get("kmers.lookup.direct")
    if not calls or direct is None:
        return None
    return 100.0 * direct / calls
