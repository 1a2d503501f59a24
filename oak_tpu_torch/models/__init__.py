from .likelihoods import Gaussian
from .svgp import SVGP

__all__ = ["Gaussian", "SVGP"]
