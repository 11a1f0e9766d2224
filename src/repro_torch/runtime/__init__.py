"""Runtime support of the port: the measurement harness.

The JAX package's fault-tolerance and ISA-control modules come with
``ROADMAP.md`` queue A items 12 and 13."""

from .timing import TimingResult, device_fingerprint, measure  # noqa: F401

__all__ = ["TimingResult", "device_fingerprint", "measure"]
