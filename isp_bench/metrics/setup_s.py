"""Set-up: process start to the window's start (imports, the kernels' load or
build, the inputs made from the seed, the warm-up), host clock."""


def read(run):
    return run.setup_s
