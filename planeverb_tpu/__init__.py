"""Former name of the ``planeverb`` package, kept so that code and commands
written against it keep working.

Importing it, or any module under it, gives the ``planeverb`` module objects
themselves (one set of modules, caches and classes under both names), and
``python -m`` with the former name runs ``planeverb/__main__.py``. New code
imports ``planeverb``.
"""

import importlib
import importlib.abc
import importlib.util
import sys

_PREFIX = __name__ + "."


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Finds ``<former name>.x`` as ``planeverb.x``. ``__main__`` is left to
    the path finder: it finds the file through this package's ``__path__``,
    which is planeverb's, and gives ``python -m`` the code to run."""

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(_PREFIX) and not fullname.endswith(".__main__"):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(
            "planeverb." + spec.name[len(_PREFIX):])
        spec.loader_state = module.__spec__   # the import system resets it
        return module

    def exec_module(self, module):
        module.__spec__ = module.__spec__.loader_state


sys.meta_path.insert(0, _Alias())
sys.modules[__name__] = importlib.import_module("planeverb")
