"""Wall time (ms) a job the parser thread spends inside one ``next`` of
the batch reader (read, allocate, native pack): the program's counter
``kmers.ingest.parse_ns`` (``io.fastx.prefetch``'s worker thread), over
the window's jobs.  The program counts only while a profiler records,
which in a traced run is the window; nothing where the program keeps no
such counter.

Spans: none (a counter of the program's own)."""

SPANS = {}


def read(run):
    from kmers_tpu_torch import profiling

    ns = getattr(profiling, "counters", dict)().get("kmers.ingest.parse_ns")
    if not ns or not run.units:
        return None
    return ns / 1e6 / len(run.units)
