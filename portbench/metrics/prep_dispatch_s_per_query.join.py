"""Host prep and dispatch: the executor's ``prep_s`` plus ``dispatch_s``
(measured by the port) a window query."""


def read(record):
    if not record.get("queries"):
        return None
    return (record["prep_s"] + record["dispatch_s"]) / record["queries"]
