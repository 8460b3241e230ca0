"""The parser thread's CPU time over its wall time inside the batch
reader's ``next`` (%): the program's counters
``kmers.ingest.parse_cpu_ns`` (``time.thread_time_ns``) over
``kmers.ingest.parse_ns`` (``time.perf_counter_ns``), as
``parse_ms.count``'s.  Near 100 the parse is CPU-bound; lower, the
thread waited on file reads or the interpreter lock.

Spans: none (counters of the program's own)."""

SPANS = {}


def read(run):
    from kmers_tpu_torch import profiling

    c = getattr(profiling, "counters", dict)()
    wall = c.get("kmers.ingest.parse_ns")
    cpu = c.get("kmers.ingest.parse_cpu_ns")
    if not wall or cpu is None:
        return None
    return 100.0 * cpu / wall
