"""The JAX package's numpy box-scene renderer
(vista_slam_tpu/datasets/synthetic_scene.py), loaded from its file.

Importing it as ``vista_slam_tpu.datasets.synthetic_scene`` would first run
that package's ``__init__``, which imports the image datasets and with them
PIL; the port renders in-memory frames on machines without PIL.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import vista_slam_tpu

_PATH = Path(vista_slam_tpu.__file__).parent / "datasets" / "synthetic_scene.py"
_spec = importlib.util.spec_from_file_location("_vista_synthetic_scene", _PATH)
_module = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_module)

BoxScene = _module.BoxScene
orbit_trajectory = _module.orbit_trajectory
