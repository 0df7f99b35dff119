"""The run's environment: fixed cache directories inside the checkout, and
the check that nothing of JAX or the JAX package was loaded.

The program builds its CUDA kernels into `build/procyon_tpu_torch/` at the
checkout's root (a path its ops/_build.py fixes). Triton's and torch's
extension caches go beside it, at fixed paths, so that only a checkout's
first run builds.
"""

import os
import sys
from pathlib import Path

# top-level module names a run may not hold, compared whole: the port's
# name, procyon_tpu_torch, begins with the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "procyon_tpu")


def prepare(root):
    build = Path(root) / "build" / "benchmark"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    # transformers, if anything loads it, would import flax and jax
    os.environ["USE_FLAX"] = "0"


def forbidden_modules(modules=None):
    """The FORBIDDEN top-level names that `modules` (sys.modules) holds."""
    names = {m.split(".")[0] for m in (modules if modules is not None
                                       else list(sys.modules))}
    return sorted(names & set(FORBIDDEN))
