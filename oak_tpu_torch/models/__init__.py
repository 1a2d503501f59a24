from .gpr import GPR
from .likelihoods import Bernoulli, Gaussian
from .sgpr import SGPR
from .svgp import SVGP

__all__ = ["Bernoulli", "GPR", "Gaussian", "SGPR", "SVGP"]
