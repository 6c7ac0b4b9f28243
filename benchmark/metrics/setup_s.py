"""Seconds from process start to the window's start: imports, the
scene's build and compile, the kernel library's load (its build on a
checkout's first run) and one warm image."""


def read(ctx):
    return ctx["setup_s"]
