"""The benchmark's own clock around its call to
``data.batching.collate``, averaged over the traced window's batches."""


def read(r):
    if not r.trace_collate_s:
        return None
    return 1e3 * sum(r.trace_collate_s) / len(r.trace_collate_s)
