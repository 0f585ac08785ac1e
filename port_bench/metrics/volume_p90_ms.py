"""The 90th percentile, over every volume of the window, of the time from
sending the volume to all its maps on the host, in ms (host clock;
numpy's linear interpolation)."""

import numpy as np


def read(ctx):
    if ctx.kind != "serve_volumes":
        return None
    return float(np.percentile(ctx.window["latencies_s"], 90)) * 1e3
