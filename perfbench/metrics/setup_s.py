"""setup_s: process start to the engine warmed up (host clock): the
imports, the weights made on the device from the seed, the engine and its
KV pool, the kernels loaded (built once per checkout) and one forward of
every shape the cell takes."""


def read(run):
    return run.setup_s
