from .sampler import GeneratorNoise, SamplerConfig, inpaint_sample

__all__ = ["GeneratorNoise", "SamplerConfig", "inpaint_sample"]
