"""setup_s: seconds from the process's start to the measured window's
opening: imports, the CUDA context, building or loading the kernels'
library, the seeded weights and inputs, the warm-up and checked steps."""


def read(ctx):
    return ctx.setup_s
