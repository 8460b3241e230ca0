"""Valid query lanes answered a second: the valid lanes of every call of
the window over the time from the first call's start to the last call's
end (each call ends when its answers are on the host).  Host clock."""

from benchmark.harness.stats import rate


def read(run):
    lanes = run.work.get("valid_lanes")
    if not lanes or not run.units:
        return None
    answered = sum(lanes[call["pool"]] for call in run.units)
    return rate(answered, run.units[0]["start"], run.units[-1]["end"])
