"""Set-up, s: from the process's start to the window's, by the host clock:
imports, the CUDA context, kernels loaded (built on a checkout's first
run), the weights drawn, the decode graph captured and the warm-up."""


def read(run):
    return run.setup_s
