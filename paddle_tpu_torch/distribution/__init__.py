"""paddle.distribution: probability distributions, transforms and the KL
divergence. reference: paddle_tpu/distribution/__init__.py (the same
names)."""

from .distribution import Distribution, ExponentialFamily  # noqa: F401
from .continuous import (  # noqa: F401
    Normal, Uniform, Beta, Gamma, Exponential, Cauchy, Chi2, Gumbel,
    Laplace, LogNormal, StudentT, ContinuousBernoulli,
)
from .discrete import (  # noqa: F401
    Bernoulli, Binomial, Categorical, Geometric, Multinomial, Poisson,
)
from .multivariate import Dirichlet, MultivariateNormal, LKJCholesky  # noqa: F401
from .transform import (  # noqa: F401
    Transform, AbsTransform, AffineTransform, ChainTransform, ExpTransform,
    IndependentTransform, PowerTransform, ReshapeTransform, SigmoidTransform,
    SoftmaxTransform, StackTransform, StickBreakingTransform, TanhTransform,
    TransformedDistribution, Independent,
)
from .kl import kl_divergence, register_kl  # noqa: F401

__all__ = [
    "Distribution", "ExponentialFamily",
    "Normal", "Uniform", "Beta", "Gamma", "Exponential", "Cauchy", "Chi2",
    "Gumbel", "Laplace", "LogNormal", "StudentT", "ContinuousBernoulli",
    "Bernoulli", "Binomial", "Categorical", "Geometric", "Multinomial",
    "Poisson", "Dirichlet", "MultivariateNormal", "LKJCholesky",
    "Transform", "AbsTransform", "AffineTransform", "ChainTransform",
    "ExpTransform", "IndependentTransform", "PowerTransform",
    "ReshapeTransform", "SigmoidTransform", "SoftmaxTransform",
    "StackTransform", "StickBreakingTransform", "TanhTransform",
    "TransformedDistribution", "Independent",
    "kl_divergence", "register_kl",
]
