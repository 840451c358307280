"""``torch.cuda.max_memory_allocated()`` over set-up and the window's
first ``mem_solves`` solves (the traffic file's), in GiB: the most device
memory the process held for the port over a fixed number of solves."""


def read(run):
    return run.peak_bytes / 2.0 ** 30 if run.peak_bytes else None
