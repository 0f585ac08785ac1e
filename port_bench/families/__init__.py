"""What the traffic kinds need of each model family, one module a
family, found by the configuration's `family` key: the reference nets,
the program's serving closure and trainer built from the harness's
weights, the reference's chunk and steps, and the kernel calls a chunk or
step makes (for the rooflines)."""

from __future__ import annotations

import torch


def closure_modules(fn) -> dict:
    """The `torch.nn.Module`s a closure holds, by variable name, looking
    through decorators' `__wrapped__`."""
    found = {}
    while fn is not None:
        code = getattr(fn, "__code__", None)
        cells = getattr(fn, "__closure__", None) or ()
        if code is not None:
            for name, cell in zip(code.co_freevars, cells):
                try:
                    val = cell.cell_contents
                except ValueError:
                    continue
                if isinstance(val, torch.nn.Module):
                    found[name] = val
        fn = getattr(fn, "__wrapped__", None)
    return found


def load_weights(module: torch.nn.Module, weights: dict) -> None:
    """Copy `weights` into `module`'s parameters in place (the optimizer
    keeps its references), every leaf of both named alike."""
    params = dict(module.named_parameters())
    if set(params) != set(weights):
        only_p = sorted(set(params) - set(weights))[:5]
        only_r = sorted(set(weights) - set(params))[:5]
        raise ValueError(f"leaves differ: program only {only_p}, "
                         f"reference only {only_r}")
    with torch.no_grad():
        for name, p in params.items():
            if p.shape != weights[name].shape:
                raise ValueError(f"{name}: {tuple(p.shape)} in the program, "
                                 f"{tuple(weights[name].shape)} here")
            p.copy_(weights[name])


def magnitude(x):
    return torch.sqrt(torch.sum(torch.square(x), dim=-1, keepdim=True))
