"""Native (C++) runtime components: the scalar golden coder
(:mod:`.golden` over ``scalar_coder.cc``, a copy of the JAX package's),
the CPU conformance check and throughput anchor of the port."""

from . import golden

__all__ = ["golden"]
