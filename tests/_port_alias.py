"""Run a JAX-package test module's own cases on the port.

:func:`on_port` executes a test module's source a second time in a fresh
namespace whose ``__import__`` resolves every ``repro`` import, at module
level or inside a function, to the same name under ``repro_torch``.  The
cases are then the same code as the JAX package's, not copies of it, and
reach the port's classes wherever they reach ``repro``'s.  Strings a case
hands to a subprocess (``python -m repro...``) are not rewritten: cases
that do so are run on the port by tests of their own.
"""

import builtins
import sys
import types

_CACHE: dict[str, types.ModuleType] = {}


def port_name(name: str) -> str:
    """``repro[.x]`` -> ``repro_torch[.x]``; any other name unchanged."""
    if name == "repro" or name.startswith("repro."):
        return "repro_torch" + name[len("repro"):]
    return name


def _import(name, globals=None, locals=None, fromlist=(), level=0):
    if level == 0:
        name = port_name(name)
    return builtins.__import__(name, globals, locals, fromlist, level)


_BUILTINS = dict(vars(builtins), __import__=_import)


def _reaches_repro(value) -> bool:
    values = (value.values() if isinstance(value, dict) else
              value if isinstance(value, (tuple, list)) else (value,))
    for v in values:
        mod = (v.__name__ if isinstance(v, types.ModuleType)
               else getattr(type(v) if not callable(v) else v,
                            "__module__", None) or "")
        if mod.split(".")[0] == "repro":
            return True
    return False


def on_port(module: types.ModuleType) -> types.ModuleType:
    """``module`` re-executed with ``repro`` resolved to ``repro_torch``
    (one copy per module per process).  Fails if any of its globals
    still comes from ``repro``."""
    got = _CACHE.get(module.__name__)
    if got is None:
        got = types.ModuleType(f"{module.__name__}__on_port")
        got.__file__ = module.__file__
        got.__builtins__ = _BUILTINS
        sys.modules[got.__name__] = got
        with open(module.__file__) as f:
            code = compile(f.read(), module.__file__, "exec")
        exec(code, vars(got))
        left = sorted(n for n, v in vars(got).items()
                      if not n.startswith("__") and _reaches_repro(v))
        assert not left, f"{module.__name__} still reaches repro: {left}"
        _CACHE[module.__name__] = got
    return got


def call_case(fn, **fixtures):
    """Call a test function with the fixtures it names."""
    names = fn.__code__.co_varnames[:fn.__code__.co_argcount]
    return fn(**{n: fixtures[n] for n in names})
