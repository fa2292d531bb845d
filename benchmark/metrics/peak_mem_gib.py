"""The card's peak memory over the run, GiB: the allocator's counter
`torch.cuda.max_memory_allocated` read when the window has closed."""


def read(rec: dict):
    return rec["memory_peak_bytes"] / 2**30 if rec["memory_peak_bytes"] else None
