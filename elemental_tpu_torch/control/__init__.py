"""Control theory: the sign-function solvers (Sylvester, Lyapunov,
Riccati)."""
from .core import sylvester, lyapunov, riccati
