"""Activation-sharding context: logical constraints inside model code,
from the JAX package's ``sharding/ctx.py``.

Layer code calls ``constrain(x, "batch", None, "heads")`` at the places
where the reference pins a layout.  Logical names resolve through the
same rule table as parameters; axes that don't divide are dropped, and
with no active context (or a one-rank mesh) the call does nothing.

On one card the ranks are leading axes of one tensor, so a constraint
changes no value and no layout: ``constrain`` returns ``x`` itself.
Under an active context of more than one rank it still resolves the
spec (a spec that maps one mesh axis to two dims raises, as the
reference's does), and while a recorder is installed
(:func:`record_constraints`, the dry run's) it records each site's
(site, local shape, spec, bytes an element), which is what the dry run
prices the activations' collectives from; :func:`note` records a site
that is no constraint (the MoE layer's buffers).
"""

from __future__ import annotations

import contextlib
import threading

from repro_torch.sharding import rules as rules_lib

_tls = threading.local()


@contextlib.contextmanager
def use_mesh_rules(mesh, rules=None):
    """Make (``mesh``, ``rules``) the active context of this thread
    (``rules`` defaults to the tp table); contexts nest, the innermost
    wins, and the previous one is restored on exit."""
    prev = getattr(_tls, "ctx", None)
    _tls.ctx = (mesh, rules or rules_lib.DEFAULT)
    try:
        yield
    finally:
        _tls.ctx = prev


def active() -> bool:
    return getattr(_tls, "ctx", None) is not None


def current():
    """The active (mesh, rules), or None."""
    return getattr(_tls, "ctx", None)


@contextlib.contextmanager
def record_constraints(into: list):
    """Append ``(site, local shape, spec, bytes an element)`` to
    ``into`` for every resolved :func:`constrain` and :func:`note` of
    this thread while the block runs."""
    prev = getattr(_tls, "rec", None)
    _tls.rec = into
    try:
        yield into
    finally:
        _tls.rec = prev


def constrain(x, *logical, site: str | None = None):
    """Return ``x`` unchanged.  Under an active context of more than one
    rank, resolve the logical axes to a divisible spec of x's shape
    (checked as a :class:`~repro_torch.sharding.rules.Sharding`) and, if
    a recorder is installed, record it under ``site`` (default: the
    logical axes joined)."""
    ctx = getattr(_tls, "ctx", None)
    if ctx is None:
        return x
    mesh, rules = ctx
    if mesh.size == 1:
        return x
    spec, local = _resolve(rules, mesh, logical, tuple(x.shape))
    note(site or "/".join(str(a) for a in logical), local, spec,
         x.element_size())
    return x


def _resolve(rules, mesh, logical, shape):
    """(spec, one rank's shape) of a constraint, checked as a
    ``Sharding``; cached on ``rules`` (a decode step meets the same
    few hundred constraints every step)."""
    key = (mesh, logical, shape)
    got = rules.resolved.get(key)
    if got is None:
        spec = rules_lib.divisible_spec(rules.mesh_axes(logical, mesh),
                                        shape, mesh)
        got = rules.resolved[key] = (
            spec, rules_lib.Sharding(mesh, spec).shard_shape(shape))
    return got


def note(site: str, shape, spec, itemsize: int) -> None:
    """Record ``(site, shape, spec, itemsize)`` if a recorder is
    installed (``shape``: one rank's)."""
    rec = getattr(_tls, "rec", None)
    if rec is not None:
        rec.append((site, tuple(shape), spec, int(itemsize)))
