"""setup_s: process start to the first timed simulation: imports, the
graph (drawn, or loaded from the checkout's cache), the program's staging
and kernel library, one warm simulation."""


def read(rec):
    return rec["setup_s"]
