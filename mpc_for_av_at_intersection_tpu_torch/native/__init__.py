"""The native C++ lattice search, built from this package's own source."""

from .build import load_native, native_available
from .search import NativeMotionPrimitiveSearch

__all__ = ["load_native", "native_available", "NativeMotionPrimitiveSearch"]
