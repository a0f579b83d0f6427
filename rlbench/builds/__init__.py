"""The models a configuration is built into, one module a build, found
by name as the per-layer metrics are.

A configuration file may name its build (``"build": "<name>"``); without
the key it is :data:`DEFAULT`.  :func:`load` imports
``rlbench.builds.<name>`` from this package's search path
(``__path__``).  A build module defines five functions:

* ``specs(config, kind)``: the weight trees a cell of ``kind``
  (``serve`` or ``train``) needs, ``{name: rlbench.weights.tree_spec
  list}``, in the order ``rlbench.weights.make_trees`` draws them.  A
  build that shares trees with ``hsm`` lists them first and its own
  after them, so that the shared trees keep their draws: on the card a
  tree's normal draws are a prefix of one ``torch.randn`` call whose
  length does not change where it falls, while the CPU's ``torch.randn``
  redraws the last 16 values of a call whose length is not a multiple
  of 16.  ``make_trees`` draws every uniform leaf after every normal
  one: a shared tree with uniform leaves (``hsm`` has none) keeps its
  draws only while the build's own trees hold no normal leaf;
* ``program_serving(config, traffic, trees, stats, device)``: the
  program's ``fn(motion, conf, keys) -> (fused, sync)``;
* ``program_training(config, trees, seed, device)``: the program's
  ``(state, step)``;
* ``reference_serving(config, traffic, trees, stats, device)``: the
  reference's ``fn(motion, conf, keys) -> fused``;
* ``reference_training(config, trees, seed, device)``: the
  reference's ``(state, step)``.

The program-side functions reach the program only through
``renderloom_torch``'s entry points; the reference-side functions
import only ``rlbench.reference`` (and the benchmark's own modules),
never the program.  Everything else of a run is the loop's
(``rlbench.serve``, ``rlbench.train``) and stays there: the inputs, the
reservoir of sampled outputs, the comparison and the FLOP count.
"""

from __future__ import annotations

import importlib
import pkgutil
from typing import List

DEFAULT = "hsm"


def names() -> List[str]:
    """The builds on the search path."""
    return sorted({m.name for m in pkgutil.iter_modules(__path__)
                   if not m.name.startswith("_")})


def name_of(config: dict) -> str:
    """The configuration's build, checked: a LookupError naming the
    builds present where there is no such build."""
    name = config.get("build", DEFAULT)
    have = names()
    if name not in have:
        raise LookupError(f"no build {name!r}; have {have}")
    return name


def load(config: dict):
    """The module of the configuration's build."""
    return importlib.import_module(f"{__name__}.{name_of(config)}")
