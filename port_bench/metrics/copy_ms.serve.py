"""Device ms of copies and memsets a served chunk (the serving loop's
host-to-card and card-to-host copies), from the traced sub-window."""


def read(ctx):
    if ctx.kind != "serve_volumes" or ctx.trace is None:
        return None
    s = ctx.trace.seconds_by("copies")
    return s * 1e3 / ctx.trace.units if s > 0 else None
