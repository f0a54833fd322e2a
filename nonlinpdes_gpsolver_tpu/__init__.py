"""The package's earlier import name, kept as an alias of
:mod:`nonlinpdes_gpsolver`: importing it, or any of its submodules, returns
the very module objects of ``nonlinpdes_gpsolver``."""

import importlib
import pkgutil
import sys

import nonlinpdes_gpsolver as _pkg

for _m in pkgutil.walk_packages(_pkg.__path__, _pkg.__name__ + "."):
    sys.modules[__name__ + _m.name[len(_pkg.__name__):]] = importlib.import_module(_m.name)
sys.modules[__name__] = _pkg
