"""setup_s: seconds from the driver's start to the first call of the
window: weights and inputs made from the seed, the program loaded, its
kernels built (only the first run in a checkout compiles) and every
shape of the cell warmed."""


def read(rec):
    return rec["setup_s"]
