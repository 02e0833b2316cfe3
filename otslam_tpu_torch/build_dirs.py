"""Where the port builds its CUDA kernels (kernels/_build.py) and its host
libraries (adapters/native.py).

In a checkout, where the package's parent directory holds a
pyproject.toml, the root is the checkout's ``build/``. An installed
package builds under the user's cache directory instead:
``$XDG_CACHE_HOME/otslam_tpu_torch``, else ``~/.cache/otslam_tpu_torch``.
The sources are always read from the package's own
``otslam_tpu_torch/csrc/`` and ``otslam_tpu_torch/native/``. A root that cannot be created or written raises, naming it.
"""

from __future__ import annotations

import os
from pathlib import Path

PACKAGE = Path(__file__).resolve().parent


def build_root() -> Path:
    """The directory under which the package builds its libraries."""
    checkout = PACKAGE.parent
    if (checkout / "pyproject.toml").is_file():
        return checkout / "build"
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "otslam_tpu_torch"


def make_build_dir(path: Path) -> Path:
    """Create `path` with its parents; RuntimeError naming it when it
    cannot be created or written."""
    try:
        path.mkdir(parents=True, exist_ok=True)
    except OSError as e:
        raise RuntimeError(f"cannot create the build directory {path}: "
                           f"{e}") from e
    if not os.access(path, os.W_OK):
        raise RuntimeError(f"the build directory {path} is not writable")
    return path
