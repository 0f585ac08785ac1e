"""The NaN sanitizer of `--debug_nans` (the counterpart of the JAX package's
`jax_debug_nans`): with it on, the first operation whose output holds a NaN
stops the run with a `FloatingPointError` that names the operation, in the
forward pass and in the backward (where it also names the autograd node).

It is a `TorchDispatchMode`, which sees every ATen operation of the thread
that turned it on, the backward's included (the autograd engine carries
the mode to its device threads); `torch.autograd.set_detect_anomaly` alone
sees only the backward. Only NaN counts, as in JAX; an infinity passes.
Operations that return uninitialized memory (`empty` and its kin) are not
checked, nor views (their output is their input's memory, checked where it
was made, or uninitialized: `nn.init` writes parameters through views), nor
`lift_fresh`, which takes in a constant the program wrote
(`torch.tensor(...)`, as a constant enters a JAX program without a
primitive). Each checked output costs a reduction and a synchronisation, so
the switch is off by default, and off it costs nothing: the mode is not on
the stack.

The port's hand-written CUDA kernels write into buffers that ATen made
with `empty`, behind the mode's back, so each kernel wrapper checks its
kernel's outputs itself where it launches it (`check_kernel_outputs`,
through `ops._build.check_launch`), and the error names the kernel.

`set_debug_nans(True)` turns it on for the calling thread until
`set_debug_nans(False)`, as JAX's flag holds for the process;
`DebugNaNs()` is the same check as a context manager.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_leaves

_UNCHECKED = ("empty", "new_empty", "empty_like", "empty_strided",
              "new_empty_strided", "resize_", "set_", "lift_fresh")


class DebugNaNs(TorchDispatchMode):
    """Raises `FloatingPointError` at the first operation whose floating or
    complex output holds a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view or func.overloadpacket.__name__ in _UNCHECKED:
            return out
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and (
                    t.is_floating_point() or t.is_complex()) \
                    and bool(torch.isnan(t).any()):
                node = torch._C._current_autograd_node()
                where = "" if node is None \
                    else f" in the backward of {node.name()}"
                raise FloatingPointError(
                    f"debug_nans: NaN in the output of {func}{where}")
        return out


_active: DebugNaNs | None = None


def set_debug_nans(on: bool) -> None:
    """Turn the sanitizer on or off for the calling thread (module
    docstring); a no-op where it already is so."""
    global _active
    if on and _active is None:
        _active = DebugNaNs()
        _active.__enter__()
    elif not on and _active is not None:
        mode, _active = _active, None
        mode.__exit__(None, None, None)


def debug_nans_enabled() -> bool:
    """Whether the sanitizer is on for the calling thread (by
    `set_debug_nans` or a `DebugNaNs()` block)."""
    return any(isinstance(m, DebugNaNs)
               for m in _get_current_dispatch_mode_stack())


def check_kernel_outputs(kernel: str, *outputs) -> None:
    """With the sanitizer on, raise `FloatingPointError` naming `kernel`
    where one of its `outputs` (tensors, or None for an output it did not
    write) holds a NaN; off, nothing."""
    if not debug_nans_enabled():
        return
    for t in outputs:
        if t is not None and bool(torch.isnan(t).any()):
            node = torch._C._current_autograd_node()
            where = "" if node is None \
                else f" in the backward of {node.name()}"
            raise FloatingPointError(
                f"debug_nans: NaN in the output of the {kernel} "
                f"kernel{where}")
