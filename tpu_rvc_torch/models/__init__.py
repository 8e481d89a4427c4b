from .synthesizer import Synthesizer, make_synthesizer

__all__ = ["Synthesizer", "make_synthesizer"]
