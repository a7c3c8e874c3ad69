"""LRC plugin of the PyTorch port: locally-repairable layered code.

The counterpart of the JAX package's ``ceph_tpu/ec/plugin_lrc.py``,
registered under the same name, ``lrc``, with the same two profile
forms.  The backend defaults to ``torch`` on the profile's ``device``
(default ``cuda``); ``native`` and ``numpy`` run on the host.  One
difference: each layer's inner codec, built only to read its coding
matrix, is built on the ``numpy`` backend (the JAX package's resolves
to ``native``), so building an LRC code allocates nothing on a card and
needs none; the matrix bytes are the same.

The capability of the reference's lrc plugin
(src/erasure-code/lrc/ErasureCodeLrc.{h,cc}: layered
chunk-pattern profiles ErasureCodeLrc.h:48-163, minimum_to_decode
preferring the cheapest layer).  Two profile forms:

1. the simple form `k=K m=M l=L`: K data chunks, M global Reed-Solomon
   parities, and one local XOR parity per group of L consecutive chunks
   over the (data + global) sequence;
2. the LAYERS grammar: `mapping=` gives the chunk roles ('D' data, '_'
   coding/local), `layers=` is a JSON list of [chunk-pattern, config]
   pairs applied in order — each pattern marks its layer's inputs 'D'
   and outputs 'c' ('_' not in layer), and the config picks the inner
   plugin/technique for that layer.  Layer outputs may feed later
   layers (the reference's pyramid/composition semantics); every
   coding position must be produced by exactly one layer.

Single failures repair from the smallest equation covering the chunk
(the cheapest-layer rule); multi-failures fall back to rank-greedy
selection over the full generator stack.
"""

from __future__ import annotations

import json

import numpy as np

from ..ops import gf256
from .general_code import GeneralMatrixCode
from .interface import ErasureCodeError, profile_int
from .registry import register

PLUGIN_API_VERSION = 1


@register("lrc")
class LrcCode(GeneralMatrixCode):
    def _init_from_profile(self) -> None:
        if "layers" in self.profile:
            self._init_layers()
            return
        self.k = profile_int(self.profile, "k", 4)
        self.global_m = profile_int(self.profile, "m", 2)
        self.l = profile_int(self.profile, "l", 3)
        if self.l <= 0 or (self.k + self.global_m) % self.l:
            raise ErasureCodeError(
                f"l={self.l} must divide k+m={self.k + self.global_m}")
        self.groups = (self.k + self.global_m) // self.l
        # total parity chunks = global + local
        self.m = self.global_m + self.groups
        k, gm = self.k, self.global_m
        C = gf256.vandermonde_matrix(k, gm)  # global parities
        # full stack rows for data+global, then local XOR rows over groups
        dg = np.concatenate([np.eye(k, dtype=np.uint8), C])  # (k+gm, k)
        local = np.zeros((self.groups, k), dtype=np.uint8)
        for g in range(self.groups):
            for member in range(g * self.l, (g + 1) * self.l):
                local[g] ^= dg[member]
        self.full = np.concatenate([dg, local])
        self._layer_eqs: list[dict[int, int]] = []
        self.profile.setdefault("backend", "torch")
        self._init_general()

    # ------------------------------------------------- layers grammar form
    def _init_layers(self) -> None:
        try:
            layers = json.loads(str(self.profile["layers"]))
        except (ValueError, TypeError) as e:
            raise ErasureCodeError(f"layers is not JSON: {e}") from e
        mapping = str(self.profile.get("mapping", ""))
        if not mapping:
            raise ErasureCodeError("layers profiles require mapping=")
        n = len(mapping)
        data_pos = [i for i, ch in enumerate(mapping) if ch == "D"]
        self.k = len(data_pos)
        self.m = n - self.k
        if self.k == 0 or self.m <= 0:
            raise ErasureCodeError(f"bad mapping {mapping!r}")
        self.groups = 0
        self.l = 0
        self.global_m = self.m
        # symbolic row per position: its GF(2^8) combination of the data
        exprs: dict[int, np.ndarray] = {}
        for idx, pos in enumerate(data_pos):
            e = np.zeros(self.k, dtype=np.uint8)
            e[idx] = 1
            exprs[pos] = e
        self._layer_eqs = []
        for entry in layers:
            if not (isinstance(entry, (list, tuple)) and len(entry) >= 1):
                raise ErasureCodeError(f"bad layer entry {entry!r}")
            pattern = str(entry[0])
            cfg = str(entry[1]) if len(entry) > 1 else ""
            if len(pattern) != n:
                raise ErasureCodeError(
                    f"layer pattern {pattern!r} length != mapping ({n})")
            ins = [i for i, ch in enumerate(pattern) if ch in "Dd"]
            outs = [i for i, ch in enumerate(pattern) if ch == "c"]
            if not ins or not outs:
                raise ErasureCodeError(
                    f"layer {pattern!r} needs inputs and outputs")
            for i in ins:
                if i not in exprs:
                    raise ErasureCodeError(
                        f"layer {pattern!r} reads position {i} before "
                        "any layer produced it (order layers bottom-up)")
            for o in outs:
                if o in exprs:
                    raise ErasureCodeError(
                        f"position {o} produced by two layers")
            M = self._layer_matrix(cfg, len(ins), len(outs))
            for j, out in enumerate(outs):
                acc = np.zeros(self.k, dtype=np.uint8)
                eq: dict[int, int] = {out: 1}
                for i, pos in enumerate(ins):
                    coef = int(M[j, i])
                    if coef:
                        acc ^= gf256.gf_mul(np.uint8(coef), exprs[pos])
                        eq[pos] = coef
                exprs[out] = acc
                self._layer_eqs.append(eq)
        undefined = [i for i in range(n) if i not in exprs]
        if undefined:
            raise ErasureCodeError(
                f"positions {undefined} not produced by any layer")
        # reorder so data chunks occupy ids [0, k) (the daemon's shard
        # convention); parity/local chunks follow in mapping order
        order = data_pos + [i for i in range(n) if i not in data_pos]
        self._pos_to_id = {pos: idx for idx, pos in enumerate(order)}
        self.full = np.stack([exprs[p] for p in order])
        self._layer_eqs = [
            {self._pos_to_id[p]: c for p, c in eq.items()}
            for eq in self._layer_eqs]
        self.profile.setdefault("backend", "torch")
        self._init_general()

    @staticmethod
    def _layer_matrix(cfg: str, k: int, m: int) -> np.ndarray:
        """Coefficient matrix of one layer's inner code.  cfg is the
        reference's space-separated `key=value` string; the inner plugin
        must be a GF(2^8) matrix code (jerasure matrix techniques / isa)
        or the XOR plugin.  The inner codec runs on the numpy backend:
        only its matrix is read."""
        opts = {}
        for tok in cfg.split():
            if "=" in tok:
                key, val = tok.split("=", 1)
                opts[key] = val
        plugin = opts.pop("plugin", "jerasure")
        opts["k"] = str(k)
        opts["m"] = str(m)
        if plugin == "xor" or (plugin == "jerasure"
                               and opts.get("technique") == "xor"):
            if m != 1:
                raise ErasureCodeError(
                    f"xor layer can produce one output, pattern wants {m}")
            return np.ones((1, k), dtype=np.uint8)
        from .registry import factory
        opts["backend"] = "numpy"
        inner = factory(plugin, opts)
        if not hasattr(inner, "matrix"):
            raise ErasureCodeError(
                f"layer plugin {plugin!r} is not a GF(2^8) matrix code")
        return np.asarray(inner.matrix, dtype=np.uint8)

    def repair_equations(self):
        """Locality relations: per-layer equations (layers grammar) or
        group XORs (simple form) + the global parity relations."""
        eqs = super().repair_equations()
        if self._layer_eqs:
            return eqs + [dict(eq) for eq in self._layer_eqs]
        for g in range(self.groups):
            eq = {self.k + self.global_m + g: 1}
            for member in range(g * self.l, (g + 1) * self.l):
                eq[member] = 1
            eqs.append(eq)
        return eqs

    def _group_of(self, chunk: int) -> int | None:
        """Locality group of a data/global chunk (None for local parities)."""
        if chunk < self.k + self.global_m:
            return chunk // self.l
        return None

    def _decode_candidates(self, want, available):
        """Prefer the failed chunk's group members (local repair), then
        data, then global, then other locals — the cheapest-layer-first
        rule of the reference's LRC minimum_to_decode."""
        if not self.l:
            # layers grammar: single failures already take the smallest
            # layer equation; multi-failures use the default order
            return super()._decode_candidates(want, available)
        avail = set(available)
        missing = [i for i in want if i not in avail]
        order: list[int] = []

        def add(ids):
            for i in ids:
                if i in avail and i not in order:
                    order.append(i)

        for miss in missing:
            g = self._group_of(miss)
            if g is None and miss >= self.k + self.global_m:
                g = miss - (self.k + self.global_m)
            if g is not None:
                add(range(g * self.l, min((g + 1) * self.l,
                                          self.k + self.global_m)))
                add([self.k + self.global_m + g])
        add(range(self.k))
        add(range(self.k, self.k + self.global_m))
        add(range(self.k + self.global_m, self.chunk_count))
        return order
