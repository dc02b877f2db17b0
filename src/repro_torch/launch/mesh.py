"""The pricing profile of the card: tiers, installation, per-axis lookup.

The port's default profile has one tier, "stacked": the p ranks of a
scan stacked on the leading axis of tensors on ONE card, where a round
is one round-kernel launch that reads the peer's rows in place (the
ring, the block family and the copy rounds still gather them).  Its constants are
the :class:`~repro_torch.core.scan_api.CostModel` defaults (α measured
on the card by ``chip_smoke.py``, β and γ from the card's HBM rate),
``source="default"``.  A calibrated profile, or one carried across
from the JAX package with ``CostProfile.from_json``, replaces it
through :func:`install_profile`; :func:`use_calibrated_profile` installs
the one stored for a rank grid's fingerprint (``core/tune.py`` fits and
stores it).
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch import device as device_lib
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
    an install invalidates every stale plan; the autotuner's install also
    flushes them (``plan_cache_resize``) to count them."""
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


def mesh_fingerprint(grid, device=None) -> str:
    """Identity of a rank grid for the calibrated-profile store: the
    device type, the card's name, and the ``((axis name, size), ...)``
    grid, as the JAX package's fingerprint of a mesh.  ``device``
    defaults to the CUDA card (raises when there is none)."""
    dev = device_lib.resolve(device)
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else dev.type
    cells = "x".join(f"{name}{int(size)}" for name, size in grid)
    return f"{dev.type}-{kind}-{cells}"


def resolve_profile(grid=None, directory: str | None = None,
                    fingerprint: str | None = None,
                    device=None) -> CostProfile:
    """The best available profile for ``grid``: a calibrated profile
    stored under its fingerprint (or under ``fingerprint``), else the
    one of the simulated calibration (``python -m
    repro_torch.core.tune --simulate``), else :data:`DEFAULT_PROFILE`."""
    from repro_torch.core import tune  # lazy: tune imports this module

    fp = fingerprint or (mesh_fingerprint(grid, device)
                         if grid is not None else None)
    if fp is not None:
        prof = tune.load_profile(fp, directory)
        if prof is not None:
            return prof
    prof = tune.load_profile("simulated-default", directory)
    return prof if prof is not None else DEFAULT_PROFILE


def use_calibrated_profile(grid=None, directory: str | None = None,
                           device=None) -> CostProfile:
    """Resolve and install the calibrated profile for ``grid`` (the
    default when none is stored); returns it so callers can log its
    provenance.  Nothing installs one unless a caller asks."""
    prof = resolve_profile(grid, directory, device=device)
    install_profile(prof if prof is not DEFAULT_PROFILE else None)
    return prof


@dataclasses.dataclass(frozen=True)
class HostMesh:
    """The rank grid a port model stands for, read as the layer code of
    the JAX package reads a ``jax.sharding.Mesh``: ``shape`` maps each
    axis name to its size, in ``axis_names`` order.  On one card the
    ranks are leading axes of its tensors, so no device is named."""

    axis_names: tuple[str, ...]
    sizes: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes) \
                or any(int(n) < 1 for n in self.sizes):
            raise ValueError(f"bad mesh {self.axis_names} {self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        """The number of ranks."""
        n = 1
        for s in self.sizes:
            n *= int(s)
        return n


def make_host_mesh(data: int = 1, model: int = 1) -> HostMesh:
    """A (data, model) rank grid, as the JAX package's
    ``make_host_mesh``; (1, 1) is one rank."""
    return HostMesh(("data", "model"), (int(data), int(model)))


def make_production_mesh(*, multi_pod: bool = False) -> HostMesh:
    """The production rank grid, as the JAX package's: one pod of 16 x 16
    ranks, axes ("data", "model"), or two pods, ("pod", "data", "model")
    = (2, 16, 16), the "pod" axis outermost.  Names and sizes only: the
    dry run prices a step on it without any device."""
    if multi_pod:
        return HostMesh(("pod", "data", "model"), (2, 16, 16))
    return HostMesh(("data", "model"), (16, 16))


def batch_axes(mesh) -> tuple[str, ...]:
    """The mesh's data-parallel axes, outermost first."""
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def data_degree(mesh) -> int:
    """The product of the data-parallel axes' sizes."""
    n = 1
    for a in batch_axes(mesh):
        n *= mesh.shape[a]
    return n
