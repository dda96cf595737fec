"""Planner: the coordinator's chunking, eviction and placement seconds
(``ExecutedQuery.time_opt_s``, measured by the port) a window query."""


def read(record):
    if not record.get("queries"):
        return None
    return record["opt_s"] / record["queries"]
