"""Lanes a weighted re-count takes in at k = 64: the program's counters
``kmers.consolidate.recount_lanes`` over ``kmers.consolidate.recounts``
(the table's capacity and the pending run-length tables', padding
included: 2^24 + 16 x 4096 x 256 = 33,554,432 at the k = 64 cell's
shapes, a batch row's windows keeping all 256 lanes).  A change that
compacts the per-batch tables or merges instead of re-counting moves
it; nothing on a program that keeps no such counter.

Spans: none (counters of the program's own)."""

SPANS = {}


def read(run):
    from kmers_tpu_torch import profiling

    c = getattr(profiling, "counters", dict)()
    recounts = c.get("kmers.consolidate.recounts")
    lanes = c.get("kmers.consolidate.recount_lanes")
    if not recounts or lanes is None:
        return None
    return lanes / recounts
