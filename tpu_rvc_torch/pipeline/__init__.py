from .vc import VC, Pipeline

__all__ = ["VC", "Pipeline"]
