"""Seconds from the process's start to the window's start: imports, the
kernel library's load (its build on a checkout's first run), the inputs,
bind, warm-up and capture."""


def read(ctx):
    return ctx.setup_s
