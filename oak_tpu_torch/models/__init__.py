from .likelihoods import Bernoulli, Gaussian
from .svgp import SVGP

__all__ = ["Bernoulli", "Gaussian", "SVGP"]
