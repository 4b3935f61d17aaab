"""The benchmark's spans and its record of kernel launches, put around calls
into the port at run time (the port records no span of its own).

* :func:`span` — a ``record_function`` range named ``pb.<name>`` in a traced
  run, nothing otherwise (end-to-end metrics are measured untraced).
* :func:`ranges` — a range around each listed method of an object, as an
  instance attribute shadowing it for the duration (``chip_smoke.py``'s
  ``ranges`` pattern, copied).
* :class:`KernelLaunches` — wraps every public ``*_call`` function of every
  module of ``repro_torch.kernels``, found at run time, in a range
  ``pb.kernel.<function>``, and while ``active`` records the bytes each
  launch is handed and returns (each tensor counted once), so a kernel
  added later is counted by the same rule.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import pkgutil

import torch

PREFIX = "pb."


def span(name: str, enabled: bool):
    if not enabled:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function(PREFIX + name)


@contextlib.contextmanager
def ranges(targets, enabled: bool = True):
    """``targets``: (object, method name, span name) triples."""
    patched = []
    if enabled:
        for obj, attr, name in targets:
            fn = getattr(obj, attr)

            def run(*args, _fn=fn, _name=name, **kwargs):
                with span(_name, True):
                    return _fn(*args, **kwargs)

            setattr(obj, attr, run)
            patched.append((obj, attr))
    try:
        yield
    finally:
        for obj, attr in patched:
            delattr(obj, attr)


def tensors(value):
    """Every tensor in ``value`` (nested tuples, lists and dicts)."""
    if torch.is_tensor(value):
        yield value
    elif isinstance(value, (tuple, list)):
        for v in value:
            yield from tensors(v)
    elif isinstance(value, dict):
        for v in value.values():
            yield from tensors(v)


def nbytes(*values) -> int:
    """The bytes of the distinct tensors among ``values``."""
    seen, total = set(), 0
    for t in tensors(values):
        key = (t.data_ptr(), t.numel(), t.dtype)
        if key not in seen:
            seen.add(key)
            total += t.numel() * t.element_size()
    return total


def kernel_functions() -> list:
    """(module, name) of every public ``*_call`` function defined in a
    module of ``repro_torch.kernels``."""
    import repro_torch.kernels as pkg

    found = []
    for info in pkgutil.iter_modules(pkg.__path__):
        mod = importlib.import_module(f"{pkg.__name__}.{info.name}")
        for name, fn in vars(mod).items():
            if (name.endswith("_call") and not name.startswith("_") and callable(fn)
                    and getattr(fn, "__module__", None) == mod.__name__):
                found.append((mod, name))
    return found


class KernelLaunches:
    """Ranges around the port's kernel wrappers; ``launches`` holds
    (function, bytes) of each call made while :attr:`active`."""

    def __init__(self):
        self.active = False
        self.launches: list = []
        self._patched: list = []
        self._depth = 0

    def install(self) -> None:
        for mod, name in kernel_functions():
            fn = getattr(mod, name)
            setattr(mod, name, self._wrap(fn, name))
            self._patched.append((mod, name, fn))

    def remove(self) -> None:
        for mod, name, fn in self._patched:
            setattr(mod, name, fn)
        self._patched = []

    def _wrap(self, fn, name):
        label = f"kernel.{name}"

        @functools.wraps(fn)
        def run(*args, **kwargs):
            if self._depth:  # a wrapper called by another: counted by the outer one
                return fn(*args, **kwargs)
            self._depth += 1
            try:
                with span(label, True):
                    out = fn(*args, **kwargs)
            finally:
                self._depth -= 1
            if self.active:
                self.launches.append((name, nbytes(args, kwargs, out)))
            return out

        return run
