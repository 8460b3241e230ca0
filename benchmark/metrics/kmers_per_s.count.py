"""K-mers counted a second, read in the traced run: the k-mers of the
cell's FASTQ file (the reference's count of its valid windows) times the
jobs of the window that exited 0, over the time from the first job's
start to the last job's end.  A job is one whole ``count`` of the file to
a saved .npz.  Host clock, under the profiler and the spans."""

from benchmark.harness.stats import rate


def read(run):
    per_job = run.work.get("kmers_per_job")
    if not per_job or not run.units:
        return None
    done = sum(1 for job in run.units if job["rc"] == 0)
    return rate(per_job * done, run.units[0]["start"], run.units[-1]["end"])
