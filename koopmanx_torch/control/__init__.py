"""control (see the package docstring)."""
from .lmi import LMIResult, solve_terminal_lmi
from .shooting import PGDConfig, shooting_cost, solve_shooting_pgd
