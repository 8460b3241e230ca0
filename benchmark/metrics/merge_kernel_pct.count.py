"""Share (%) of the consolidations' table merges whose runs the run-reduce
kernel K13 reduced on the card: the program's counters
``kmers.consolidate.reduced`` over ``kmers.consolidate.merges``, as
``lookup_direct_pct.lookup``'s.  100 where every merge of sorted unit keys
ran K13; nothing on a program that keeps no such counter.

Spans: none (counters of the program's own)."""

SPANS = {}


def read(run):
    from kmers_tpu_torch import profiling

    c = getattr(profiling, "counters", dict)()
    merges = c.get("kmers.consolidate.merges")
    reduced = c.get("kmers.consolidate.reduced")
    if not merges or reduced is None:
        return None
    return 100.0 * reduced / merges
