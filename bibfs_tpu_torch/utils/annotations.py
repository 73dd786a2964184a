"""``@guarded_by`` — declare which lock protects which shared attributes
(a copy of ``bibfs_tpu/analysis/annotations.py``).

    @guarded_by("_lock", "_graph", "_host_solver")
    class _GraphRuntime: ...

reads "``self._graph`` and ``self._host_solver`` may only be MUTATED
inside a ``with self._lock:`` block", with two exemptions:
``__init__``/``__new__`` (construction happens-before publication) and
methods named ``*_locked`` (the callee-holds-the-lock convention). The
first argument may be a tuple of names when several attributes alias one
lock. Lock-free reads remain legal.

At runtime the decorator only attaches metadata
(``__bibfs_guarded_by__``: attr -> tuple of guard names, merged down the
MRO). The lint rule that checks it statically scans the JAX package
only; re-scoping the analysis to this package is ROADMAP Queue 1,
item 11.
"""

from __future__ import annotations


def guarded_by(lock, *attrs):
    """Class decorator: ``attrs`` are mutated only under ``self.<lock>``
    (``lock`` may be a tuple of aliases for the same underlying lock).
    Stackable — each application merges into the class metadata."""
    guards = (lock,) if isinstance(lock, str) else tuple(lock)
    if not guards or not all(isinstance(g, str) for g in guards):
        raise TypeError("guarded_by needs a lock attribute name (or a "
                        "tuple of alias names)")
    if not attrs or not all(isinstance(a, str) for a in attrs):
        raise TypeError("guarded_by needs at least one guarded "
                        "attribute name")

    def deco(cls):
        merged = {}
        for base in reversed(cls.__mro__[1:]):
            merged.update(getattr(base, "__bibfs_guarded_by__", {}))
        merged.update(cls.__dict__.get("__bibfs_guarded_by__", {}))
        for a in attrs:
            merged[a] = guards
        cls.__bibfs_guarded_by__ = merged
        return cls

    return deco
