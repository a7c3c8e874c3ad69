"""Erasure-code plugin registry.

The PyTorch port's analogue of the reference's ErasureCodePluginRegistry
(src/erasure-code/ErasureCodePlugin.cc:104 factory, :138
dlopen load, :96 register_builtin, preload from config): plugins register
factories under a name; `factory(name, profile)` instantiates a codec.
Instead of dlopen'ing libec_<name>.so, out-of-tree plugins are imported by
module path (`ceph_tpu_torch.ec.plugin_<name>` by convention, or any
"pkg.module" name given in the profile's `plugin_module`); the version
handshake of __erasure_code_version() becomes an API_VERSION attribute
check.  One level down, the builtin plugin dispatches its region math
to the hand-written CUDA kernels (csrc/, loaded through ctypes).
"""

from __future__ import annotations

import importlib
import threading
from typing import Callable

from .interface import ErasureCode, ErasureCodeError, Profile

API_VERSION = 1

_FACTORIES: dict[str, Callable[[Profile], ErasureCode]] = {}
_LOCK = threading.Lock()


def register(name: str):
    """Decorator: register a plugin factory (class or callable)."""

    def deco(factory: Callable[[Profile], ErasureCode]):
        with _LOCK:
            _FACTORIES[name] = factory
        return factory

    return deco


def _load(name: str, profile: Profile) -> None:
    """Import a plugin module so it can self-register (the dlopen
    equivalent, ref ErasureCodePlugin.cc:138-206)."""
    module = dict(profile).get("plugin_module",
                               f"ceph_tpu_torch.ec.plugin_{name}")
    try:
        mod = importlib.import_module(module)
    except ImportError as e:
        raise ErasureCodeError(f"no erasure-code plugin {name!r} "
                               f"(import {module} failed: {e})") from e
    ver = getattr(mod, "PLUGIN_API_VERSION", None)
    if ver != API_VERSION:
        # the __erasure_code_version() mismatch check (ref :166-176)
        raise ErasureCodeError(
            f"plugin {name!r} API version {ver} != {API_VERSION}")
    if name not in _FACTORIES:
        raise ErasureCodeError(
            f"module {module} did not register plugin {name!r}")


def factory(name: str, profile: Profile | None = None) -> ErasureCode:
    """Instantiate plugin `name` with `profile` (ref :104)."""
    profile = dict(profile or {})
    profile.setdefault("plugin", name)
    with _LOCK:
        f = _FACTORIES.get(name)
    if f is None:
        _load(name, profile)
        with _LOCK:
            f = _FACTORIES[name]
    return f(profile)


def preload(names: list[str]) -> None:
    """Import a list of plugins up front (config osd_erasure_code_plugins)."""
    for n in names:
        if n not in _FACTORIES:
            _load(n, {})


def registered() -> list[str]:
    with _LOCK:
        return sorted(_FACTORIES)
