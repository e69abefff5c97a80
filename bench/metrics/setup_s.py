"""setup_s: process start to the window's first op (host clock): loading,
the graph's making on the card, the kernels' load (and, in a checkout's
first run, their build), the step's capture and the typed rings."""


def read(run):
    return run.setup_s
