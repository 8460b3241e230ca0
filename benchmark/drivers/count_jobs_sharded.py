"""``count_jobs`` over a mesh: the same whole file-to-table CLI jobs, with
the configuration's sharding flags (``devices``, ``partition``,
``route_capacity``) added to each job's arguments, so that the CLI
builds its ``ShardedStreamingCounter`` over that many cards.  Set-up,
window and check are ``count_jobs``'s; a job whose routing overflows
exits 3 and counts as failed."""

from __future__ import annotations

from benchmark.harness import spec

count_jobs = spec.load_driver("count_jobs")


class Driver(count_jobs.Driver):
    def count_argv(self, out: str) -> list:
        c = self.cfg
        return super().count_argv(out) + [
            "--devices", str(c["devices"]), "--partition", c["partition"],
            "--route-capacity", str(c["route_capacity"])]
