"""Object classes: server-side compute in the OSD IO path.

The capability of the reference's ClassHandler + src/cls/* (dlopen'd
object classes — lock, version, cmpomap, ... — whose methods run
INSIDE the OSD against the object, ref src/osd/ClassHandler.cc and the
`call` op in PrimaryLogPG::do_osd_ops): a registry of named classes;
a method receives a context exposing the object's data/omap and QUEUES
mutations, which the primary then applies through the normal
replicated write path (so class effects replicate and log like any
other write).

Built-ins mirror the most-used reference classes:
- lock: advisory object locks in omap (cls_lock)
- version: a cas-guarded version counter in omap (cls_version)
"""

from __future__ import annotations

import threading
import time
from typing import Callable

from ..msg.wire import pack_value as pack, unpack_value as unpack


class ClsError(Exception):
    def __init__(self, code: int, what: str):
        super().__init__(what)
        self.code = code


class ClsContext:
    """What a class method sees: read the object, queue mutations."""

    def __init__(self, data: bytes, omap: dict, exists: bool):
        self._data = data
        self._omap = dict(omap)
        self.exists = exists
        # queued effects, applied atomically by the primary afterwards
        self.new_data: bytes | None = None
        self.omap_set: dict[str, bytes] = {}
        self.omap_rm: set[str] = set()

    def read(self) -> bytes:
        return self._data

    def write(self, data: bytes) -> None:
        self.new_data = bytes(data)

    def omap_get(self, key: str) -> bytes | None:
        if key in self.omap_rm:
            return None
        if key in self.omap_set:
            return self.omap_set[key]
        return self._omap.get(key)

    def omap_all(self) -> dict:
        out = {k: v for k, v in self._omap.items()
               if k not in self.omap_rm}
        out.update(self.omap_set)
        return out

    def set_omap(self, key: str, value: bytes) -> None:
        self.omap_rm.discard(key)
        self.omap_set[key] = bytes(value)

    def rm_omap(self, key: str) -> None:
        self.omap_set.pop(key, None)
        self.omap_rm.add(key)


_CLASSES: dict[str, dict[str, Callable]] = {}
_LOCK = threading.Lock()


def register_class(cls_name: str, method: str):
    """Register `cls_name.method` (the cls_register_cxx_method role)."""

    def deco(fn):
        with _LOCK:
            _CLASSES.setdefault(cls_name, {})[method] = fn
        return fn

    return deco


def call(cls_name: str, method: str, ctx: ClsContext, inp) -> object:
    with _LOCK:
        fn = _CLASSES.get(cls_name, {}).get(method)
    if fn is None:
        raise ClsError(-22, f"no class method {cls_name}.{method}")
    return fn(ctx, inp if inp is not None else {})


def registered() -> dict[str, list[str]]:
    with _LOCK:
        return {c: sorted(m) for c, m in sorted(_CLASSES.items())}


# ---------------------------------------------------------------- cls_lock
_LOCK_KEY = "lock.%s"


@register_class("lock", "lock")
def _cls_lock(ctx: ClsContext, inp) -> object:
    name, owner, exclusive = inp["name"], inp["owner"], \
        bool(inp.get("exclusive", True))
    raw = ctx.omap_get(_LOCK_KEY % name)
    state = unpack(raw) or {"exclusive": exclusive, "owners": []}
    owners = list(state["owners"])
    if owners:
        if state["exclusive"] or exclusive:
            if owners != [owner]:
                raise ClsError(-16, f"lock {name!r} held by {owners}")
        elif owner in owners:
            pass  # re-entrant shared
        else:
            owners.append(owner)
    else:
        owners = [owner]
        state["exclusive"] = exclusive
    state["owners"] = owners
    state["stamp"] = time.time()
    ctx.set_omap(_LOCK_KEY % name, pack(state))
    return {"owners": owners}


@register_class("lock", "unlock")
def _cls_unlock(ctx: ClsContext, inp) -> object:
    name, owner = inp["name"], inp["owner"]
    state = unpack(ctx.omap_get(_LOCK_KEY % name))
    if not state or owner not in state["owners"]:
        raise ClsError(-2, f"{owner!r} does not hold lock {name!r}")
    state["owners"] = [o for o in state["owners"] if o != owner]
    if state["owners"]:
        ctx.set_omap(_LOCK_KEY % name, pack(state))
    else:
        ctx.rm_omap(_LOCK_KEY % name)
    return {}


@register_class("lock", "break_lock")
def _cls_break_lock(ctx: ClsContext, inp) -> object:
    ctx.rm_omap(_LOCK_KEY % inp["name"])
    return {}


@register_class("lock", "info")
def _cls_lock_info(ctx: ClsContext, inp) -> object:
    state = unpack(ctx.omap_get(_LOCK_KEY % inp["name"]))
    return state or {}


# ------------------------------------------------------------- cls_version
_VER_KEY = "version.v"


@register_class("version", "read")
def _cls_ver_read(ctx: ClsContext, inp) -> object:
    return {"ver": unpack(ctx.omap_get(_VER_KEY)) or 0}


@register_class("version", "set")
def _cls_ver_set(ctx: ClsContext, inp) -> object:
    ctx.set_omap(_VER_KEY, pack(int(inp["ver"])))
    return {}


@register_class("version", "inc")
def _cls_ver_inc(ctx: ClsContext, inp) -> object:
    cur = unpack(ctx.omap_get(_VER_KEY)) or 0
    expect = inp.get("expect")
    if expect is not None and cur != expect:
        raise ClsError(-125, f"version is {cur}, expected {expect}")
    ctx.set_omap(_VER_KEY, pack(cur + 1))
    return {"ver": cur + 1}
