"""Version queries (≙ the reference's include/splatt/api_version.h:47-61),
the JAX package's numbers."""

version_major = 0
version_minor = 5
version_patch = 0

__version__ = f"{version_major}.{version_minor}.{version_patch}"
