"""setup_s (s, end to end, host clock): seconds from the start of the
process to the end of warm-up -- interpreter and library start, the CUDA
context, building or loading the kernels, making the inputs on the card,
the program's set-up (for reads, the archive's encode) and the warm-up."""


def read(r):
    return r.setup_s
