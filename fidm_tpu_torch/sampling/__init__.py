from .cfg import classifier_free, drop_labels
from .sampler import GeneratorNoise, SamplerConfig, inpaint_sample, sample

__all__ = ["GeneratorNoise", "SamplerConfig", "classifier_free", "drop_labels",
           "inpaint_sample", "sample"]
