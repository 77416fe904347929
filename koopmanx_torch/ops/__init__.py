"""ops (see the package docstring). The fused condensed-QP entry points
are exported here, as ``koopmanx/ops/__init__.py`` exports them."""
from .fused_qp import FusedQPConfig, fused_qp_solve
from .fused_qp_soa import fused_qp_solve_soa

__all__ = ["FusedQPConfig", "fused_qp_solve", "fused_qp_solve_soa"]
