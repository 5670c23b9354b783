"""SubStrat's system layer in PyTorch: measures, Gen-DST, strategies, plans.

Public surface: the plan-based pipeline API (DESIGN.md §12).
"""
from .plan import Plan, execute, plan, plan_from_config
from .strategies import (
    SubsetResult, available_strategies, get_strategy, register_strategy,
    run_strategy,
)

__all__ = [
    "Plan", "plan", "execute", "plan_from_config",
    "SubsetResult", "register_strategy", "get_strategy",
    "available_strategies", "run_strategy",
]
