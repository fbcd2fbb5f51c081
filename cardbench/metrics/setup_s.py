"""setup_s: seconds from the start of the process to the window's first
due arrival: imports, weights, kernel libraries (a build in a fresh
checkout), the handler and the warm-up of every shape the cell uses."""


def read(run):
    return run.setup_s
