"""setup_s: process start to the window's start (imports, inputs, kernel
builds and the warm-up), host clock."""


def read(ctx):
    return ctx.get("setup_s")
