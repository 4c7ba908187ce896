"""The package's former import name, kept so existing callers still work.

Everything is in ``pano``. Importing ``<this package>.<module>`` gives the
very module object ``pano.<module>`` (one copy, so patches and caches are
shared), and ``python -m <this package>.cli`` runs the CLI.
"""

import importlib
import importlib.abc
import importlib.util
import sys

from pano import *  # noqa: F401,F403
from pano import __all__, __version__  # noqa: F401


class _Alias(importlib.abc.MetaPathFinder, importlib.abc.Loader):
    """Resolves ``<this package>.X`` to the module ``pano.X``."""

    def __init__(self):
        self._specs = {}

    @staticmethod
    def _target(fullname):
        return "pano" + fullname[len(__name__):]

    def find_spec(self, fullname, path=None, target=None):
        if fullname.startswith(__name__ + "."):
            return importlib.util.spec_from_loader(fullname, self)
        return None

    def create_module(self, spec):
        module = importlib.import_module(self._target(spec.name))
        self._specs[module.__name__] = module.__spec__
        return module

    def exec_module(self, module):
        # The import system stamped the alias spec on the module; give it
        # back its own.
        module.__spec__ = self._specs.pop(module.__name__)

    def get_code(self, fullname):
        """For ``python -m``: the code of the module the alias names."""
        name = self._target(fullname)
        return importlib.util.find_spec(name).loader.get_code(name)


sys.meta_path.insert(0, _Alias())
