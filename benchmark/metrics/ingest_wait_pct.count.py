"""Share of the job walls (%) in which the main thread waits inside
``fastx.prefetch``'s iterator for the parser thread's next batch.

Spans: ``ingest_wait``, every ``next`` of the iterator that
``kmers_tpu_torch.io.fastx.prefetch`` returns (the CLI's stream loop);
``job``, the harness's span around each whole CLI job."""

SPANS = {"ingest_wait": ["iter:kmers_tpu_torch.io.fastx:prefetch"]}


def read(run):
    t = run.trace
    if t is None:
        return None
    jobs, wait = t.intervals("job"), t.intervals("ingest_wait")
    if not jobs.items or not wait.items:
        return None
    return 100.0 * wait.overlap(jobs) / jobs.length
