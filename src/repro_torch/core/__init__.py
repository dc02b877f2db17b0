"""Monoids, the schedule IR, the stacked-rank executor and the planner."""
