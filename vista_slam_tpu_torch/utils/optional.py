"""Optional host packages (OpenCV, matplotlib).

The port imports them only where work starts, so that a machine without
them (the card's has no OpenCV) still runs everything else. Where one is
missing, the caller gets a ModuleNotFoundError that names the package and
what needed it, never a silent fall back.
"""

from __future__ import annotations

import importlib


def missing(module: str, package: str, user: str) -> ModuleNotFoundError:
    """The error for ``user`` needing ``package`` (imported as ``module``)."""
    return ModuleNotFoundError(f"{user} needs {package} ({module}), which is not installed",
                               name=module)


def require(module: str, package: str, user: str = "this script"):
    """Import ``module``, or raise ``missing(module, package, user)``."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        raise missing(module, package, user) from e
