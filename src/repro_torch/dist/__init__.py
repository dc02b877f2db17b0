"""Scan schedules across OS processes through ``torch.distributed``.

:class:`~repro_torch.core.schedule.SPMDExecutor` runs one schedule rank
in each process of a process group: a round is a point-to-point send
and receive, an all-gather an ``all_gather``, and every ⊕ a round
kernel.  :mod:`repro_torch.dist.launcher` spawns and drives such
processes: :class:`WorkerPool` keeps ``nprocs`` of them alive across
runs, scatters per-rank payloads, gathers the stacked results, and
returns a :class:`DistResult`; ``python -m repro_torch.dist.launcher
--nprocs 2 --smoke`` runs one exscan through it and holds the result
bit for bit against ``StackedExecutor``.
"""

__all__ = ["DistResult", "WorkerPool", "run_plan"]


def __getattr__(name):
    # imported on first use, so ``python -m repro_torch.dist.launcher``
    # does not find its module imported already by its package
    if name in __all__:
        from repro_torch.dist import launcher

        return getattr(launcher, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
