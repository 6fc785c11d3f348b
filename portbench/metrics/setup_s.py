"""Set-up: seconds from the process's start to the window's (imports, the
kernels' libraries, parameters, the warm-up on the window's shapes)."""


def read(ctx):
    return ctx["setup_s"]
