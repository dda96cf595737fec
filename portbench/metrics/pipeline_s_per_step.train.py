"""Token pipeline: host seconds in ``next_batch`` a step, mean over the
window's steps (the benchmark's host clock around the call)."""


def read(record):
    if not record.get("steps"):
        return None
    return record["pipeline_s"] / record["steps"]
