"""peak_mem_gib: ``torch.cuda.max_memory_allocated`` over the run, set-up
and window (the step programs' memory is allocated at their capture and
reused by every replay), in GiB."""


def read(run):
    if run.peak_bytes <= 0:
        return None
    return run.peak_bytes / 2 ** 30
