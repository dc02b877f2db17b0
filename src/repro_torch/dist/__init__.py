"""Scan schedules across OS processes through ``torch.distributed``.

:class:`~repro_torch.core.schedule.SPMDExecutor` runs a block of
consecutive schedule ranks (one or more) in each process of a process
group: rows whose peer is in the block are read in place, rows whose
peer is in another process travel as one point-to-point message a peer
process and round, an all-gather is an ``all_gather``, and every ⊕ a
round kernel over the block.  :mod:`repro_torch.dist.launcher` spawns
and drives such processes: :class:`WorkerPool` keeps ``nprocs`` of them
(``p_intra`` ranks each) alive across runs, scatters the blocks,
gathers the stacked results, and returns a :class:`DistResult`;
``python -m repro_torch.dist.launcher --nprocs 2 [--p-intra 4]
--smoke`` runs one exscan through it and holds the result bit for bit
against ``StackedExecutor``.
"""

__all__ = ["DistResult", "WorkerPool", "run_plan"]


def __getattr__(name):
    # imported on first use, so ``python -m repro_torch.dist.launcher``
    # does not find its module imported already by its package
    if name in __all__:
        from repro_torch.dist import launcher

        return getattr(launcher, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
