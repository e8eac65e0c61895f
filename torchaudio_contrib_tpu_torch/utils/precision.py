"""Mixed-precision training helpers: FP32 master weights, a reduced
compute dtype inside the differentiated function.

Port of ``torchaudio_contrib_tpu/utils/precision.py``: keep the parameters
in float32 and cast them, and the inputs, to ``compute_dtype`` (bfloat16
by default) *inside* the function that is differentiated.  ``Tensor.to``
is differentiable and casts the gradient back, so gradients with respect
to the float32 parameters come back in float32; bfloat16 has float32's
exponent range, so no loss scaling is needed.  On the card the products
then run on the BF16 tensor cores with FP32 accumulation.

This is the port's one opt-in to reduced precision: the models pin their
convolutions and RNNs to FP32 cuDNN otherwise (``models._common``), and a
module run under :func:`mixed_precision` still does, in bfloat16.  A
module's parameters enter as a dict through ``torch.func.functional_call``::

    params = dict(model.named_parameters())
    loss = mixed_precision(
        lambda p, x: torch.func.functional_call(model, p, (x,)).sum())
    loss(params, x).backward()      # model's .grad: float32
"""
from __future__ import annotations

import torch

__all__ = ["cast_floats", "mixed_precision"]


def cast_floats(tree, dtype):
    """Cast every floating-point tensor leaf of ``tree`` (nested dicts,
    lists and tuples) to ``dtype``.

    Integer, boolean and complex tensors pass through untouched (there is
    no bfloat16 complex; labels and indices stay integral), and so do
    non-tensor leaves (Python scalars, None, strings).
    """
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return type(tree)((k, cast_floats(v, dtype))
                          for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(cast_floats(v, dtype) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_floats(v, dtype) for v in tree)
    return tree


def mixed_precision(fn, compute_dtype=torch.bfloat16, *,
                    cast_args=True, output_dtype=torch.float32):
    """Wrap ``fn(params, *args, **kwargs)`` to run in ``compute_dtype``.

    The wrapper casts the floating leaves of ``params`` (and of the other
    arguments when ``cast_args``) to ``compute_dtype`` before calling
    ``fn``, then casts floating outputs to ``output_dtype``
    (``output_dtype=None`` returns ``fn``'s own dtypes).  The casts are
    inside the wrapper, so a gradient with respect to ``params`` comes
    back in each parameter's own (float32) dtype::

        loss_bf16 = mixed_precision(loss_fn)
        loss_bf16(params_f32, batch).backward()     # grads: float32
    """
    def wrapped(params, *args, **kwargs):
        params = cast_floats(params, compute_dtype)
        if cast_args:
            args = cast_floats(args, compute_dtype)
            kwargs = cast_floats(kwargs, compute_dtype)
        out = fn(params, *args, **kwargs)
        if output_dtype is not None:
            out = cast_floats(out, output_dtype)
        return out

    return wrapped
