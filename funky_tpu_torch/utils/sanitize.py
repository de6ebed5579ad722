"""Numeric sanitizers (port of funky_tpu/utils/sanitize.py), the
counterpart of a GPU validation layer for what can go wrong in a frame
made of tensor ops: NaN or Inf creeping in from a bad asset or a division
by zero.

- `checked(fn)`: the counterpart of checkify's float checks. Every op fn
  dispatches is checked, and the first one whose floating output holds a
  NaN or an Inf that none of its inputs held raises, naming the op. Debug
  only: it reads every output on the host, a sync per op.
- `assert_finite(tree)`: a post-hoc scan of a frame's outputs, cheap
  enough for the driver's sanitize mode (one reduction and one read per
  tensor).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves


def _bad(x) -> tuple:
    """(has NaN, has Inf) of a floating tensor or a Python float."""
    if isinstance(x, torch.Tensor):
        if not x.is_floating_point() or x.numel() == 0:
            return False, False
        return bool(torch.isnan(x).any()), bool(torch.isinf(x).any())
    if isinstance(x, float):
        return x != x, x in (float("inf"), float("-inf"))
    return False, False


class _FloatChecks(TorchDispatchMode):
    """Raises FloatingPointError at the first op that makes a NaN or an
    Inf from inputs without one (sdf-style clamps and masks that keep
    values finite pass)."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        made = [_bad(x) for x in tree_leaves(out)]
        if any(n or i for n, i in made):
            had = [_bad(x) for x in tree_leaves((args, kwargs))]
            nan_in = any(n for n, _ in had)
            inf_in = any(i for _, i in had)
            for n, i in made:
                if (n and not nan_in) or (i and not inf_in):
                    raise FloatingPointError(
                        f"{func} produced a {'nan' if n else 'inf'} from "
                        f"finite inputs")
        return out


def checked(fn):
    """Wrap a frame function with per-op NaN/Inf checks (sanitize.py:
    23-42). Returns wrapped(*args) -> result; raises FloatingPointError
    naming the op that first made a NaN or an Inf. Usage:
        frame = sanitize.checked(functools.partial(render_gltf_frame,
                                                   cfg=cfg))
        rgba, state = frame(scene, params, state)
    """
    def wrapped(*args, **kwargs):
        with _FloatChecks():
            return fn(*args, **kwargs)

    return wrapped


def _leaves(tree, path=""):
    """(path, tensor) over nested dicts, NamedTuples, lists and tuples."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}['{k}']")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k in tree._fields:
            yield from _leaves(getattr(tree, k), f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for k, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{k}]")
    elif isinstance(tree, torch.Tensor):
        yield path, tree


def assert_finite(tree, label: str = "frame output") -> None:
    """Raise FloatingPointError naming every floating tensor of `tree` (a
    dict, NamedTuple, list or tuple of tensors, nested) that holds a
    non-finite value (sanitize.py:45-55). Integer tensors are skipped."""
    bad = []
    for path, leaf in _leaves(tree):
        if not leaf.is_floating_point():
            continue
        n = int((~torch.isfinite(leaf)).sum())
        if n:
            bad.append(f"{path}: {n} non-finite")
    if bad:
        raise FloatingPointError(f"{label}: " + "; ".join(bad))
