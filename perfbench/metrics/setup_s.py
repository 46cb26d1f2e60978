"""setup_s: seconds from the run's start to its window's (imports, the
world, the program's start, the base population converged unshaped)."""


def read(run):
    return run.setup_s
