"""Token pipeline: the share of the window's steps whose batch scanned
no raw file, % (``PipelineStats.cache_hit_steps / steps``)."""


def read(record):
    if not record.get("pipeline_steps"):
        return None
    return 100.0 * record["pipeline_cache_hit_steps"] / \
        record["pipeline_steps"]
