"""Seconds from the process's start to the first measured request:
imports, weights, the program's import and fuse, its kernels' build or
load, graph capture, warm-up."""


def read(r):
    return r["setup_s"]
