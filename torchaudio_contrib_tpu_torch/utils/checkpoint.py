"""Parameter files in the JAX package's ``.npz`` format.

Port of ``save_params``/``load_params`` of
``torchaudio_contrib_tpu/utils/checkpoint.py``: a nested structure of
arrays (dicts, lists, tuples; ``None`` allowed and stored as nothing) is
written as ``leaf_0 … leaf_{n-1}`` in ``jax.tree_util`` order (dict keys
sorted, lists and tuples in order), with the ``__treedef__`` string JAX
prints for that structure and a ``__meta__`` record.  Files cross both
ways: the JAX package's ``load_params`` reads what :func:`save_params`
writes (its structure check compares the ``__treedef__`` strings), and
:func:`load_params` reads the JAX package's files.  A JAX model's params
read this way become a port ``state_dict`` through ``utils.convert``'s
``*_from_jax_params``; that is how the bundles' ``checkpoint=`` works.

No JAX is imported: the structure is read back from the ``__treedef__``
string itself (dicts, lists, tuples and ``None`` of the JAX package's
parameter trees; a custom pytree node raises).

:func:`save_checkpoint`/:func:`load_checkpoint` are the sharded
checkpoints, in ``torch.distributed.checkpoint`` (DCP)'s directory format
where the JAX package writes orbax's: every rank writes its own shards of
its DTensors (FSDP or tensor-parallel parameters), and a load reshards to
the layout of ``like``, so a checkpoint saved from two ranks loads on one
and the reverse.  Orbax files are not read.
"""
from __future__ import annotations

import ast
import io
import json
import tokenize
from typing import Any

import numpy as np
import torch

__all__ = ["save_params", "load_params", "save_checkpoint",
           "load_checkpoint"]

_FORMAT_VERSION = 1


def _leaves(tree: Any) -> list:
    """Leaves in ``jax.tree_util`` order (``None`` is no leaf)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _treedef(tree: Any) -> str:
    """The structure as ``str(jax.tree_util.tree_structure(tree))``
    prints it, without the ``PyTreeDef(...)`` wrapper."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, tuple):
        inner = ", ".join(_treedef(v) for v in tree)
        return "(" + inner + ("," if len(tree) == 1 else "") + ")"
    if isinstance(tree, list):
        return "[" + ", ".join(_treedef(v) for v in tree) + "]"
    return "*"


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _blob(obj: Any) -> np.ndarray:
    return np.frombuffer(json.dumps(obj).encode(), dtype=np.uint8)


def save_params(path, params: Any) -> None:
    """Write a nested structure of arrays or tensors (``None`` allowed) to
    ``path`` (.npz), as the JAX package's ``save_params`` does."""
    leaves = _leaves(params)
    arrays = {f"leaf_{i}": _numpy(x) for i, x in enumerate(leaves)}
    arrays["__treedef__"] = _blob(f"PyTreeDef({_treedef(params)})")
    arrays["__meta__"] = _blob({"format_version": _FORMAT_VERSION,
                                "n_leaves": len(leaves)})
    np.savez(path, **arrays)


def _parse_treedef(text: str) -> Any:
    """A ``PyTreeDef(...)`` string → the structure, with ``0`` at each
    leaf (``*`` is swapped for ``0`` token by token, so a ``*`` inside a
    key is kept)."""
    if not (text.startswith("PyTreeDef(") and text.endswith(")")):
        raise ValueError(f"not a PyTreeDef string: {text[:60]!r}")
    body = text[len("PyTreeDef("):-1]
    toks = [(tokenize.NUMBER, "0") if t.type == tokenize.OP
            and t.string == "*" else (t.type, t.string)
            for t in tokenize.generate_tokens(io.StringIO(body).readline)]
    try:
        return ast.literal_eval(tokenize.untokenize(toks))
    except (ValueError, SyntaxError) as exc:
        raise ValueError("the checkpoint's tree holds a node other than "
                         "dicts, lists, tuples and None: "
                         f"{body[:80]!r}") from exc


def _fill(tree: Any, leaves) -> Any:
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _fill(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple):
        return tuple(_fill(v, leaves) for v in tree)
    if isinstance(tree, list):
        return [_fill(v, leaves) for v in tree]
    return next(leaves)


def load_params(path, like: Any = None) -> Any:
    """Read a file of :func:`save_params` or the JAX package's.

    With ``like`` (a nested structure of arrays or tensors, the params the
    file should hold) the checks are the JAX package's: the same number of
    leaves, the same structure (the ``__treedef__`` strings, where the file
    has one) and the same shape leaf by leaf; the result has ``like``'s
    structure.  Without it the structure is rebuilt from the file's
    ``__treedef__``.  Leaves come back as NumPy arrays.
    """
    with np.load(path) as data:
        n = sum(1 for k in data.files if k.startswith("leaf_"))
        stored = json.loads(bytes(data["__treedef__"]).decode()) \
            if "__treedef__" in data.files else None
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    if like is None:
        if stored is None:
            raise ValueError("the checkpoint has no __treedef__: pass like=")
        tree = _parse_treedef(stored)
    else:
        tree = like
        want = _leaves(like)
        if n != len(want):
            raise ValueError(
                f"checkpoint has {n} leaves; expected {len(want)} — was it "
                "saved from a different config?")
        expected = f"PyTreeDef({_treedef(like)})"
        if stored is not None and stored != expected:
            raise ValueError(
                "checkpoint tree structure mismatch — saved from a "
                f"different config?\n  checkpoint: {stored}\n"
                f"  expected:   {expected}")
        for old, new in zip(want, leaves):
            if tuple(np.shape(_numpy(old))) != tuple(new.shape):
                raise ValueError(
                    f"leaf shape mismatch: checkpoint {new.shape} vs model "
                    f"{np.shape(_numpy(old))}")
    if len(_leaves(tree)) != n:
        raise ValueError(f"checkpoint has {n} leaves; its structure has "
                         f"{len(_leaves(tree))}")
    return _fill(tree, iter(leaves))


# -- sharded checkpoints (torch.distributed.checkpoint) ----------------------

def _state(obj: Any) -> dict:
    if isinstance(obj, torch.nn.Module):
        return obj.state_dict()
    if not isinstance(obj, dict):
        raise TypeError("a checkpoint holds a module or a dict of tensors, "
                        f"got {type(obj).__name__}")
    return obj


def save_checkpoint(path: str, params: Any) -> None:
    """Write ``params`` (a module, whose ``state_dict`` is saved, or a
    dict of tensors and DTensors) to the directory ``path``.  Under a
    process group every rank calls it and writes its own shards; without
    one the process writes everything.  An existing checkpoint there is
    overwritten."""
    import os

    import torch.distributed.checkpoint as dcp

    dcp.save(_state(params), checkpoint_id=os.path.abspath(path))


def load_checkpoint(path: str, like: Any) -> Any:
    """Read a :func:`save_checkpoint` directory into the layout of
    ``like``: a module (loaded in place and returned) or a dict of tensors
    and DTensors, whose shapes, dtypes and placements say what each rank
    reads (a new dict is returned; ``like``'s tensors are filled in
    place)."""
    import os

    import torch.distributed.checkpoint as dcp

    state = _state(like)
    dcp.load(state, checkpoint_id=os.path.abspath(path))
    if isinstance(like, torch.nn.Module):
        like.load_state_dict(state)
        return like
    return dict(state)
