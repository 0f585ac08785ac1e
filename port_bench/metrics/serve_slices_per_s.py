"""Served slices a second: the slices whose maps reached the host in the
window, padding not counted, over the window, on the host's clock."""


def read(ctx):
    if ctx.kind != "serve_volumes":
        return None
    return ctx.window["slices"] / ctx.window["window_s"]
