"""Trained slices a second: the window's steps times the batch (a step
pair counts its batch once), over the window, which ends in a
synchronization with the card (host clock)."""


def read(ctx):
    if ctx.kind != "train_steps":
        return None
    return ctx.window["slices"] / ctx.window["window_s"]
