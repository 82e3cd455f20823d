"""Peak device memory, GB (1e9 bytes): torch.cuda.max_memory_allocated()
over set-up and window."""


def read(run):
    if run.memory_peak_bytes is None:
        return None
    return run.memory_peak_bytes / 1e9
