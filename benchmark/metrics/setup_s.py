"""Set-up time (s): from the start of the process to the opening of the
measured window: imports and the CUDA context, the kernel library (built
by nvcc on a checkout's first run, loaded after it), the simulated reads,
and the warm-up the cell's traffic needs (a whole job; or the table, the
query pool and one call a pool batch).  Host clock."""


def read(run):
    return run.setup_s
