"""Share (%) of the merges of sorted tables whose merges and run
reduction ran on the card: the program's counters
``kmers.consolidate.sorted_reduced`` over
``kmers.consolidate.sorted_merges``, as ``merge_kernel_pct.count``'s.
100 where every consolidation of the k = 32 cell ran its kernels;
nothing on a program that keeps no such counter.

Spans: none (counters of the program's own)."""

SPANS = {}


def read(run):
    from kmers_tpu_torch import profiling

    c = getattr(profiling, "counters", dict)()
    merges = c.get("kmers.consolidate.sorted_merges")
    reduced = c.get("kmers.consolidate.sorted_reduced")
    if not merges or reduced is None:
        return None
    return 100.0 * reduced / merges
