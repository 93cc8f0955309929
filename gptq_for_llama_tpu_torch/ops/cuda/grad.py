"""Gradients around the kernels.

A kernel writes its output through a raw pointer, so the tensor a wrapper
returns has no autograd graph. The dispatches of the training path (kernels
1, 2, 5, 6) go through a ``torch.autograd.Function`` where a gradient is
wanted (``needs_grad``); every wrapper refuses to run where a gradient is
wanted outside such a Function (``refuse_grad``), so a gradient is never
dropped silently. Inside a Function's forward grad mode is off.
"""

from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """Whether a call must carry a gradient: grad mode is on and an input
    requires one."""
    return torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors)


def refuse_grad(what: str, *tensors) -> None:
    if needs_grad(*tensors):
        raise RuntimeError(f"{what}: the kernel's output carries no gradient; call it through "
                           f"its dispatch (which differentiates it) or under torch.no_grad()")


def plain_grads(ctx, plain, g, *extra, need=None):
    """Backward of a Function whose forward ran a kernel and which has no
    backward kernel (the TPU package has none either): the gradient of the
    plain version ``plain(*saved, *extra)``, recomputed from the saved inputs.
    ``g`` is the output's gradient, or a tuple of gradients where ``plain``
    returns a tuple of outputs. ``need`` says which saved tensors want a
    gradient (by default the Function's inputs, in the order saved).
    Returns one gradient (or None) per saved tensor, then None per extra."""
    if need is None:
        need = ctx.needs_input_grad[:len(ctx.saved_tensors)]
    with torch.enable_grad():
        xs = [t.detach().requires_grad_(n) for t, n in zip(ctx.saved_tensors, need)]
        ys = plain(*xs, *extra)
    if isinstance(ys, tuple):   # outputs that depend on no wanted input carry none
        ys, g = zip(*((y, gy) for y, gy in zip(ys, g) if y.requires_grad))
    grads = iter(torch.autograd.grad(ys, [t for t, n in zip(xs, need) if n], g))
    return (*(next(grads) if n else None for n in need), *(None for _ in extra))
