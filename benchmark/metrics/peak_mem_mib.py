"""Peak device memory (MiB) over the window:
``torch.cuda.max_memory_allocated()``, reset when the window opens, on
the fullest device.  The harness reads the CUDA caching allocator's
statistics itself; the program reports nothing."""


def read(run):
    return run.peak_bytes / 2 ** 20 if run.peak_bytes else None
