"""The pricing profile of the card: tiers, installation, per-axis lookup.

The port's default profile has one tier, "stacked": the p ranks of a
scan stacked on the leading axis of tensors on ONE card, where a round
is a rank-axis gather plus one round-kernel launch.  Its constants are
the :class:`~repro_torch.core.scan_api.CostModel` defaults (α measured
on the card by ``chip_smoke.py``, β and γ from the card's HBM rate),
``source="default"``.  A calibrated profile, or one carried across
from the JAX package with ``CostProfile.from_json``, replaces it
through :func:`install_profile`.
"""

from __future__ import annotations

from repro_torch.core.scan_api import CostModel, CostProfile

STACKED_COST = CostModel()

DEFAULT_PROFILE = CostProfile(
    tiers=(("stacked", STACKED_COST),), source="default",
    default_tier="stacked")

_active_profile: CostProfile | None = None


def install_profile(profile: CostProfile | None) -> CostProfile | None:
    """Install ``profile`` as the pricing source :func:`axis_cost_model`
    resolves (None restores the default).  Returns the previously
    installed profile.  The plan cache keys on resolved constants, so
    an install invalidates every stale plan without a flush."""
    global _active_profile
    prev = _active_profile
    _active_profile = profile
    return prev


def current_profile() -> CostProfile:
    """The installed profile, or the default one."""
    return _active_profile or DEFAULT_PROFILE


def axis_cost_model(axis_name) -> CostModel:
    """Per-axis pricing kernel from the installed profile (installable
    as the ambient planner model: ``use_cost_model(axis_cost_model)``)."""
    return current_profile().for_axis(axis_name)
