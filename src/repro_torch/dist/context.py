"""Thread-local distribution context: tagged activation-constraint switches
(port of ``repro.dist.context``).

The model stack (``repro_torch.models``) is written once, mesh-agnostic.
Layout decisions belong to the step builders in ``repro_torch.launch.
steps``, which know the mesh and the ``MeshConfig``.  This module is the
conduit: a builder wraps a round in :func:`residual_constraint`,
registering constraint functions under string tags; the model calls
:func:`apply` at the tagged program points (``transformer.block_forward``:
``"attn_qkv"`` after the QKV projection, ``"attn_out"`` before the
out-projection) and :func:`apply_residual` after each unit of
``transformer.stack_forward``.  With no context installed every call is
the identity, so every path without a mesh runs the same model code.

The stack is thread-local, so two threads building programs for different
meshes do not see each other's slots.  Frames nest innermost-wins per tag,
falling through to outer frames for tags the inner one does not define.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Any, Callable, Dict, Optional

ConstraintFn = Callable[[Any], Any]

# slot name of the residual-stream constraint (``apply_residual``)
RESIDUAL = "residual"

_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def current_slots() -> Dict[str, ConstraintFn]:
    """Effective tag -> constraint mapping (outer frames shadowed by
    inner); a diagnostic and test helper."""
    out: Dict[str, ConstraintFn] = {}
    for frame in _stack():
        out.update(frame)
    return out


def slot(tag: str) -> Optional[ConstraintFn]:
    """The innermost function registered under ``tag``, or None."""
    for frame in reversed(_stack()):
        fn = frame.get(tag)
        if fn is not None:
            return fn
    return None


def apply(tag: str, x):
    """The innermost constraint registered under ``tag`` applied to ``x``,
    or ``x`` itself."""
    fn = slot(tag)
    return x if fn is None else fn(x)


def apply_residual(x):
    """Re-pins the residual stream to the installed layout (identity if
    none): ``(fsdp, model)`` or ``(fsdp,)`` per ``MeshConfig.
    residual_mode``, see ``repro_torch.dist.sharding.residual_axes``."""
    return apply(RESIDUAL, x)


@contextlib.contextmanager
def residual_constraint(residual: Optional[ConstraintFn] = None,
                        **slots: ConstraintFn):
    """Installs constraint functions for the dynamic extent of the block.

    ``residual`` becomes the :func:`apply_residual` target; keyword slots
    register further tagged switches (``attn_qkv`` / ``attn_out``, the
    serving and training meshes' collectives of ``dist.tensor_parallel``).
    Re-entrant: nested blocks shadow outer tags and restore them on exit.
    """
    frame = dict(slots)
    if residual is not None:
        frame[RESIDUAL] = residual
    stack = _stack()
    stack.append(frame)
    try:
        yield
    finally:
        stack.pop()
