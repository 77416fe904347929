"""The reference's parts, each found by the name the configuration gives
it, in a module of its own under the checkout's
``benchmark/reference/``:

- ``plants/<plant.system>.py``: ``vector_field(x, u, th)``, the plant's
  continuous dynamics over a batch (``th`` a dict of parameters);
- ``integrators/<run_config.integrator>.py``: ``step(f, x, u, th, h)``,
  one step of length h of the vector field ``f``;
- ``lifts/<run_config.lift.kind>.py``: ``dictionary(lift, root, store,
  kw)``, the lift's raw dictionary g(x) as a callable taking ``mm`` (the
  reference's matrix product) and a batch of states;
- ``estimators/<run_config.update.mode>.py``: the online estimator (see
  ``estimators/rls.py``).

A later configuration with another plant, lift or estimator brings its
part as a new file here.
"""
from __future__ import annotations

import importlib.util
import os
from typing import Callable, Dict

from torch import Tensor


def part(kind: str, name: str, root: str):
    """The module ``benchmark/reference/<kind>/<name>.py`` under ``root``
    (the checkout), loaded by its path."""
    path = os.path.join(root, "benchmark", "reference", kind, f"{name}.py")
    if not os.path.isfile(path):
        raise NotImplementedError(f"the reference has no {kind[:-1]} "
                                  f"{name!r} ({path})")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_reference_{kind}_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def plant_function(config: dict, root: str
                   ) -> Callable[[Tensor, Tensor, Dict[str, Tensor]], Tensor]:
    """One plant step of the configuration, ``step(x, u, th)``: its
    plant's vector field under its integrator, of its step length."""
    f = part("plants", config["plant"]["system"], root).vector_field
    integrate = part("integrators", config["run_config"]["integrator"], root).step
    h = config["run_config"]["data"]["h"]
    return lambda x, u, th: integrate(f, x, u, th, h)
