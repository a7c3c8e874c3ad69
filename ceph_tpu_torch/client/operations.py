"""Compound object operations: librados ObjectWriteOperation /
ObjectReadOperation.

The capability of the reference's op batching (src/librados/librados_cxx.cc
ObjectWriteOperation/ObjectReadOperation; src/osdc/Objecter.h ObjectOperation
accumulates osd_op_t entries; PrimaryLogPG::do_osd_ops executes the vector
in order inside ONE transaction — all-or-nothing, any failing step aborts
the whole op): a builder accumulates steps client-side, `RadosClient.
operate`/`operate_read` ships them as one MOSDOp, and the OSD executes
them atomically under the object's write lock.

Steps are plain dicts (packed by the versioned wire codec), so the OSD
side needs no class imports; unknown step names fail EINVAL server-side
rather than being silently skipped.
"""

from __future__ import annotations


class ObjectWriteOperation:
    """Accumulates mutating steps; executed atomically by the primary.

    Guard steps (assert_exists / assert_version / create(exclusive))
    are evaluated against the object's pre-op state BEFORE any mutation
    is applied; any failure aborts the batch with nothing written —
    the do_osd_ops error-unwind contract.
    """

    def __init__(self):
        self.steps: list[dict] = []

    # ------------------------------------------------------------- guards
    def assert_exists(self) -> "ObjectWriteOperation":
        self.steps.append({"op": "assert_exists"})
        return self

    def assert_version(self, version: int) -> "ObjectWriteOperation":
        """Fail with ERANGE unless the object's user-visible version
        matches (rados_write_op_assert_version)."""
        self.steps.append({"op": "assert_version", "ver": int(version)})
        return self

    def create(self, exclusive: bool = False) -> "ObjectWriteOperation":
        """Ensure the object exists; exclusive=True fails EEXIST if it
        already does (rados_write_op_create)."""
        self.steps.append({"op": "create", "excl": bool(exclusive)})
        return self

    # ------------------------------------------------------------ mutation
    def write_full(self, data: bytes) -> "ObjectWriteOperation":
        self.steps.append({"op": "write_full", "data": bytes(data)})
        return self

    def write(self, data: bytes, offset: int) -> "ObjectWriteOperation":
        self.steps.append({"op": "write", "data": bytes(data),
                           "off": int(offset)})
        return self

    def append(self, data: bytes) -> "ObjectWriteOperation":
        self.steps.append({"op": "append", "data": bytes(data)})
        return self

    def truncate(self, size: int) -> "ObjectWriteOperation":
        self.steps.append({"op": "truncate", "size": int(size)})
        return self

    def zero(self, offset: int, length: int) -> "ObjectWriteOperation":
        self.steps.append({"op": "zero", "off": int(offset),
                           "len": int(length)})
        return self

    def remove(self) -> "ObjectWriteOperation":
        self.steps.append({"op": "remove"})
        return self

    # ----------------------------------------------------- xattrs and omap
    def setxattr(self, name: str, value: bytes) -> "ObjectWriteOperation":
        self.steps.append({"op": "setxattr", "name": str(name),
                           "value": bytes(value)})
        return self

    def rmxattr(self, name: str) -> "ObjectWriteOperation":
        self.steps.append({"op": "rmxattr", "name": str(name)})
        return self

    def omap_set(self, kv: dict) -> "ObjectWriteOperation":
        self.steps.append({"op": "omap_set",
                           "kv": {str(k): bytes(v)
                                  for k, v in kv.items()}})
        return self

    def omap_rm(self, keys) -> "ObjectWriteOperation":
        self.steps.append({"op": "omap_rm",
                           "keys": [str(k) for k in keys]})
        return self


class ObjectReadOperation:
    """Accumulates read-only steps; `operate_read` returns one result
    per step, in order (the ObjectReadOperation out-param vector)."""

    def __init__(self):
        self.steps: list[dict] = []

    def read(self, offset: int = 0, length: int = 0) -> "ObjectReadOperation":
        self.steps.append({"op": "read", "off": int(offset),
                           "len": int(length)})
        return self

    def stat(self) -> "ObjectReadOperation":
        self.steps.append({"op": "stat"})
        return self

    def omap_get(self) -> "ObjectReadOperation":
        self.steps.append({"op": "omap_get"})
        return self

    def getxattrs(self) -> "ObjectReadOperation":
        self.steps.append({"op": "getxattrs"})
        return self

    def assert_exists(self) -> "ObjectReadOperation":
        self.steps.append({"op": "assert_exists"})
        return self
