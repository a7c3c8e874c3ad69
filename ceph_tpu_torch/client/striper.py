"""Striper: RAID-0 spreading of one logical byte stream across objects.

The capability of the reference's Striper/libradosstriper
(src/osdc/Striper.h:36-74 file_to_extents/extent_to_file over
file_layout_t{stripe_unit, stripe_count, object_size}
src/include/fs_types.h:107; src/libradosstriper) — the sequence-parallel
analogue of SURVEY.md §5: byte x of the stream maps through (stripe unit,
stripe count, object size) to (object number, offset), and a striped file
becomes many RADOS objects written/read in parallel.
"""

from __future__ import annotations

from dataclasses import dataclass

from .rados import RadosClient


@dataclass(frozen=True)
class FileLayout:
    """file_layout_t: su bytes per strip, sc objects per stripe row,
    object_size bytes per object (multiple of su)."""

    stripe_unit: int = 65536
    stripe_count: int = 4
    object_size: int = 4 * 1024 * 1024

    def __post_init__(self):
        if self.stripe_unit <= 0 or self.stripe_count <= 0:
            raise ValueError("bad layout")
        if self.object_size % self.stripe_unit:
            raise ValueError("object_size must be a multiple of stripe_unit")

    @property
    def stripe_width(self) -> int:
        return self.stripe_unit * self.stripe_count

    @property
    def stripes_per_object(self) -> int:
        return self.object_size // self.stripe_unit

    def file_to_extents(self, off: int, length: int):
        """Yield (object_no, obj_off, len) covering [off, off+length) —
        Striper::file_to_extents."""
        end = off + length
        while off < end:
            blockno = off // self.stripe_unit
            stripeno = blockno // self.stripe_count
            stripepos = blockno % self.stripe_count
            objectsetno = stripeno // self.stripes_per_object
            objectno = objectsetno * self.stripe_count + stripepos
            block_in_obj = stripeno % self.stripes_per_object
            off_in_block = off % self.stripe_unit
            obj_off = block_in_obj * self.stripe_unit + off_in_block
            take = min(self.stripe_unit - off_in_block, end - off)
            yield objectno, obj_off, take
            off += take

    def extent_to_file(self, objectno: int, obj_off: int) -> int:
        """Inverse mapping — Striper::extent_to_file."""
        objectsetno, stripepos = divmod(objectno, self.stripe_count)
        block_in_obj, off_in_block = divmod(obj_off, self.stripe_unit)
        stripeno = objectsetno * self.stripes_per_object + block_in_obj
        blockno = stripeno * self.stripe_count + stripepos
        return blockno * self.stripe_unit + off_in_block


class StripedObject:
    """A striped logical object over a RadosClient pool (libradosstriper
    shape: write/read/stat/remove at arbitrary offsets, size tracked in
    object 0's header piece)."""

    def __init__(self, client: RadosClient, pool: str, name: str,
                 layout: FileLayout | None = None):
        self.client = client
        self.pool = pool
        self.name = name
        self.layout = layout or FileLayout()

    def _piece(self, objectno: int) -> str:
        return f"{self.name}.{objectno:016x}"

    def write(self, off: int, data: bytes) -> None:
        """Stripe-aware write: extents are grouped per object piece so each
        touched piece gets exactly ONE read-modify-write round trip."""
        per_obj: dict[int, list[tuple[int, int, int]]] = {}
        pos = 0
        for objno, obj_off, take in self.layout.file_to_extents(
                off, len(data)):
            per_obj.setdefault(objno, []).append((obj_off, pos, take))
            pos += take
        for objno, extents in per_obj.items():
            piece = self._piece(objno)
            try:
                old = self.client.read(self.pool, piece)
            except Exception:  # noqa: BLE001 - absent piece
                old = b""
            end = max(o + t for o, _p, t in extents)
            buf = bytearray(max(len(old), end))
            buf[: len(old)] = old
            for obj_off, p, take in extents:
                buf[obj_off:obj_off + take] = data[p:p + take]
            self.client.write_full(self.pool, piece, bytes(buf))
        size = self.size()
        if off + len(data) > size:
            self._set_size(off + len(data))

    def read(self, off: int = 0, length: int | None = None) -> bytes:
        size = self.size()
        if length is None:
            length = max(0, size - off)
        length = max(0, min(length, size - off))
        out = bytearray(length)
        pos = 0
        for objno, obj_off, take in self.layout.file_to_extents(off, length):
            try:
                piece = self.client.read(self.pool, self._piece(objno),
                                         offset=obj_off, length=take)
            except Exception:  # noqa: BLE001 - sparse hole
                piece = b""
            out[pos:pos + len(piece)] = piece
            pos += take
        return bytes(out)

    def size(self) -> int:
        try:
            raw = self.client.read(self.pool, f"{self.name}.size")
            return int.from_bytes(raw, "little")
        except Exception:  # noqa: BLE001
            return 0

    def _set_size(self, size: int) -> None:
        self.client.write_full(self.pool, f"{self.name}.size",
                               size.to_bytes(8, "little"))

    def remove(self) -> None:
        size = self.size()
        seen = set()
        for objno, _o, _t in self.layout.file_to_extents(0, max(size, 1)):
            if objno not in seen:
                seen.add(objno)
                try:
                    self.client.remove(self.pool, self._piece(objno))
                except Exception:  # noqa: BLE001
                    pass
        try:
            self.client.remove(self.pool, f"{self.name}.size")
        except Exception:  # noqa: BLE001
            pass
