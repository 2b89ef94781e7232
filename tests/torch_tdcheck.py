"""tools/tdcheck's models bound to the port's modules.

`tools/tdcheck/models.py` and `instrument.py` import the JAX package's
federation, replication, server.workers and store.mvcc, and define their
defaults and seeded mutants (`BrokenFleetArbiter`, `BrokenSeqlockState`,
...) over its classes. This module executes the same two sources with
every `gpu_docker_api_tpu` import read as `gpu_docker_api_tpu_torch`, as
the modules `_tdcheck_port.instrument` and `_tdcheck_port.models` (a
package registered in sys.modules when this module is imported): their
module globals, every sweep's default class and every mutant then bind the
port's classes, while the scheduler (`tools/tdcheck/sched.py`, which
imports neither package) is the one module both share, so an
InvariantViolation is the same class either way. Nothing under tools/ is
edited.

    from torch_tdcheck import models, instrument
"""

from __future__ import annotations

import os
import re
import sys
import types

from tools.tdcheck import sched

_TOOLS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools", "tdcheck")
_PKG = "_tdcheck_port"


def _load(name: str) -> types.ModuleType:
    path = os.path.join(_TOOLS, f"{name}.py")
    src = open(path, encoding="utf-8").read()
    src = re.sub(r"\bgpu_docker_api_tpu\b(?!_torch)",
                 "gpu_docker_api_tpu_torch", src)
    mod = types.ModuleType(f"{_PKG}.{name}")
    mod.__file__ = path
    mod.__package__ = _PKG
    sys.modules[mod.__name__] = mod
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def _package() -> types.ModuleType:
    pkg = sys.modules.get(_PKG)
    if pkg is not None and hasattr(pkg, "models"):
        return pkg
    pkg = types.ModuleType(_PKG)
    pkg.__path__ = []
    sys.modules[_PKG] = pkg
    sys.modules[f"{_PKG}.sched"] = sched
    pkg.sched = sched
    pkg.instrument = _load("instrument")
    pkg.models = _load("models")
    return pkg


_pkg = _package()
instrument = _pkg.instrument
models = _pkg.models
