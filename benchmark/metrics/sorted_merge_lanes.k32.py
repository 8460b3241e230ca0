"""Lanes the last merge of a consolidation takes in: the program's
counters ``kmers.consolidate.sorted_lanes`` over
``kmers.consolidate.sorted_merges`` (the table's live prefix and the
pending tables' live lanes, a run each; against the re-count's
33,554,432 lanes at the k = 32 cell's shapes).  Nothing on a program
that keeps no such counter.

Spans: none (counters of the program's own)."""

SPANS = {}


def read(run):
    from kmers_tpu_torch import profiling

    c = getattr(profiling, "counters", dict)()
    merges = c.get("kmers.consolidate.sorted_merges")
    lanes = c.get("kmers.consolidate.sorted_lanes")
    if not merges or lanes is None:
        return None
    return lanes / merges
