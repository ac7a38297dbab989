"""Native (C++) components of the port, built with g++ at their first use
and loaded through ctypes (plain ``extern "C"`` symbols). Every caller has
a numpy version to fall back to where no compiler is present."""

from forwardtacotron_torch.native.build import load_library  # noqa: F401
