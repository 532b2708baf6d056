"""peak_mem_gib: the fullest card's peak allocated bytes over the window, in
GiB: ``torch.cuda.max_memory_allocated()`` of the harness's process, or a
larger peak that the client pattern's ``peaks()`` reads of the cards its own
processes hold; every peak statistic reset at the window's start."""


def read(rec):
    return rec.peak_bytes / 2**30 if rec.peak_bytes else None
