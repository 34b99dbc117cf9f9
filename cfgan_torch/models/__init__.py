"""Generators, discriminators and classifiers (mirrors `cfgan/models`)."""
from cfgan_torch.models.classifiers import (CNNClassifier, LegacyCNNClassifier,
                                            MLPClassifier, TabularClassifier)
from cfgan_torch.models.discriminators import (
    CondConvDiscriminator,
    ConditionalMLPDiscriminator,
    DCGANDiscriminator,
    MLPDiscriminator,
    SpectralMLPDiscriminator,
    WGANCritic,
)
from cfgan_torch.models.generators import (
    ConditionalMLPGenerator,
    DCGANGenerator,
    ImageResidualGenerator,
    MLPGenerator,
    MLPImageGenerator,
    MoonsResidualGenerator,
    TabularResidualGenerator,
    WGANGenerator,
)

__all__ = [
    "CNNClassifier",
    "LegacyCNNClassifier",
    "MLPClassifier",
    "TabularClassifier",
    "CondConvDiscriminator",
    "ConditionalMLPDiscriminator",
    "DCGANDiscriminator",
    "MLPDiscriminator",
    "SpectralMLPDiscriminator",
    "WGANCritic",
    "ConditionalMLPGenerator",
    "DCGANGenerator",
    "ImageResidualGenerator",
    "MLPGenerator",
    "MLPImageGenerator",
    "MoonsResidualGenerator",
    "TabularResidualGenerator",
    "WGANGenerator",
]
