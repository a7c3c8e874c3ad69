"""The wide and local codes of the port (ceph_tpu_torch/ec/general_code.py,
plugin_lrc.py, plugin_shec.py, plugin_clay.py) against the JAX package's
on the same seeded inputs: the generator stacks and CLAY's pair tables
element by element, encode, every erasure set of up to m chunks (decoded
byte-exact, or refused where the JAX package refuses: SHEC is not MDS),
minimum_to_decode, repair_cost, fold_rows, _fold_matrix, fold_sig, and
CLAY's sub-chunk repair, its folded form and its d < n-1 fallback.

The port runs on the ``torch`` backend on the CPU (the kernels' plain
versions) and on the ``native`` backend; the JAX package on its
``native`` backend, as its own tests run it.  Every comparison is
byte-exact (tolerance 0).  The port's two deliberate differences are
pinned here too: the wide plugins default to ``backend=torch`` on
``device=cuda``, and LRC builds its inner layer codecs on ``numpy``."""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu import ec as ref_ec
from ceph_tpu_torch import ec
from ceph_tpu_torch.ec import registry

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

#: the layers-grammar profile of tests/test_ec_wide_codes.py
LAYERS_PROFILE = {
    "mapping": "DD_DD__",
    "layers": ('[["DDcDD__", "plugin=jerasure technique=reed_sol_van"],'
               ' ["DD___c_", "plugin=xor"],'
               ' ["___DD_c", "plugin=xor"]]'),
}

#: tests/test_ec_wide_codes.py's WIDE_PROFILES, then the corpus grid's two
#: CLAY configurations (k=5 m=3 d=7 is shortened: one virtual node)
PROFILES = [
    ("clay", {"k": "4", "m": "2", "d": "5"}),
    ("clay", {"k": "3", "m": "3", "d": "4"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("lrc", dict(LAYERS_PROFILE)),
    ("shec", {"k": "8", "m": "4", "c": "3"}),
    ("clay", {"k": "5", "m": "3", "d": "7"}),
    ("clay", {"k": "8", "m": "4", "d": "11"}),
]
IDS = ["clay-4-2-5", "clay-3-3-4", "lrc-4-2-3", "lrc-layers",
       "shec-8-4-3", "clay-5-3-7", "clay-8-4-11"]
CLAY = [p for p in PROFILES if p[0] == "clay"]
CLAY_IDS = [i for i in IDS if i.startswith("clay")]
BACKENDS = ["torch", "native"]


def _port(plugin, prof, backend):
    extra = {"device": "cpu"} if backend == "torch" else {}
    return ec.factory(plugin, dict(prof, backend=backend, **extra))


def _ref(plugin, prof):
    return ref_ec.factory(plugin, dict(prof, backend="native"))


def _chunk_len(codec):
    """A short chunk: whole sub-chunks for CLAY, an odd width for the
    others."""
    return codec.get_sub_chunk_count() * (8 if codec.alpha > 16 else 24) \
        if hasattr(codec, "alpha") else 333


def _full(codec, data):
    parity = codec.encode_chunks(data)
    out = {i: data[i] for i in range(codec.k)}
    out.update({codec.k + j: parity[j] for j in range(codec.m)})
    return out


@pytest.mark.parametrize("plugin,prof", PROFILES, ids=IDS)
def test_generator_stacks_equal_the_reference(plugin, prof):
    port, ref = _port(plugin, prof, "torch"), _ref(plugin, prof)
    assert (port.k, port.m, port.chunk_count) == (ref.k, ref.m,
                                                  ref.chunk_count)
    for name in ("full", "matrix"):
        assert np.array_equal(getattr(port, name), getattr(ref, name))
    if plugin == "clay":
        for name in ("H", "_pn", "_pz", "_digits"):
            assert np.array_equal(getattr(port, name), getattr(ref, name))
        assert (port.q, port.t, port.nu, port.alpha, port._inv_det) == \
            (ref.q, ref.t, ref.nu, ref.alpha, ref._inv_det)
        assert [port.repair_planes(i) for i in range(port.chunk_count)] \
            == [ref.repair_planes(i) for i in range(ref.chunk_count)]
    else:
        assert port.repair_equations() == ref.repair_equations()
    if plugin == "shec":
        assert port.window == ref.window == 6
    assert port.get_sub_chunk_count() == ref.get_sub_chunk_count()
    assert int(port.get_flags()) == int(ref.get_flags())
    for width in (4096, 1 << 20, 12345):
        assert port.get_chunk_size(width) == ref.get_chunk_size(width)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("plugin,prof", PROFILES, ids=IDS)
def test_encode_equals_the_reference(plugin, prof, backend):
    port, ref = _port(plugin, prof, backend), _ref(plugin, prof)
    rng = np.random.default_rng(len(IDS[PROFILES.index((plugin, prof))]))
    L = _chunk_len(port)
    data = rng.integers(0, 256, (port.k, L), dtype=np.uint8)
    assert np.array_equal(port.encode_chunks(data), ref.encode_chunks(data))
    obj = rng.integers(0, 256, 5000, dtype=np.uint8).tobytes()
    got, want = port.encode(obj), ref.encode(obj)
    assert sorted(got) == sorted(want)
    assert all(np.array_equal(got[i], want[i]) for i in want)
    parity, csums = port.encode_chunks_with_csums(data)
    want_p, want_c = ref.encode_chunks_with_csums(data)
    assert np.array_equal(parity, want_p)
    assert np.array_equal(csums, want_c)


#: sets of 3 and 4 erasures that the torch backend decodes for CLAY k=8
#: m=4 d=11, drawn with a seed: its Python coupling loop and the plain
#: kernel versions take ~27 ms a set on the CPU, so every one of its 793
#: sets is decoded on the native backend, and on torch every set of 1 or
#: 2 and this sample of the 715 larger ones
WIDE_SAMPLE = 60


def _erasure_sets(port, backend):
    n = port.chunk_count
    sets = [e for r in range(1, port.m + 1)
            for e in itertools.combinations(range(n), r)]
    if backend == "torch" and port.k == 8 and hasattr(port, "alpha"):
        small = [e for e in sets if len(e) <= 2]
        large = [e for e in sets if len(e) > 2]
        pick = np.random.default_rng(8411).choice(len(large), WIDE_SAMPLE,
                                                  replace=False)
        sets = small + [large[i] for i in sorted(pick)]
    return sets


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("plugin,prof", PROFILES, ids=IDS)
def test_every_erasure_set_up_to_m(plugin, prof, backend):
    """Every set of 1 to m erased chunks (_erasure_sets) decodes to the
    reference's bytes (and the stored chunks), or raises
    ErasureCodeError where the reference raises — SHEC's envelope:
    every single failure and most double and triple ones decode, as
    test_lrc_shec.py requires."""
    port, ref = _port(plugin, prof, backend), _ref(plugin, prof)
    rng = np.random.default_rng(11)
    L = _chunk_len(port)
    full = _full(ref, rng.integers(0, 256, (port.k, L), dtype=np.uint8))
    total = {r: 0 for r in range(1, port.m + 1)}
    decoded = dict.fromkeys(total, 0)
    for erased in _erasure_sets(port, backend):
        r = len(erased)
        total[r] += 1
        avail = {i: c for i, c in full.items() if i not in erased}
        try:
            want = ref.decode(list(erased), dict(avail))
        except ref_ec.ErasureCodeError:
            with pytest.raises(ec.ErasureCodeError):
                port.decode(list(erased), dict(avail))
            continue
        got = port.decode(list(erased), dict(avail))
        for i in erased:
            assert np.array_equal(got[i], want[i]), (erased, i)
            assert np.array_equal(got[i], full[i]), (erased, i)
        decoded[r] += 1
    assert decoded[1] == total[1]
    if plugin == "shec":
        assert decoded[2] + decoded[3] > 0.85 * (total[2] + total[3])
        assert decoded[4] < total[4]  # the envelope was exercised
    elif plugin == "clay":
        assert decoded == total  # an MDS code


@pytest.mark.parametrize("plugin,prof", PROFILES, ids=IDS)
def test_minimum_to_decode_repair_cost_and_fold_protocol(plugin, prof):
    """minimum_to_decode, repair_cost, fold_sig, the fold kinds, and for
    the general codes fold_rows and _fold_matrix, for every single
    erasure and every pair, as the reference gives them."""
    port, ref = _port(plugin, prof, "torch"), _ref(plugin, prof)
    n = port.chunk_count
    assert port.fold_sig() == ref.fold_sig()
    assert port.encode_fold_kind() == ref.encode_fold_kind()
    assert port.decode_fold_kind() == ref.decode_fold_kind()
    for lost in itertools.chain(((i,) for i in range(n)),
                                itertools.combinations(range(n), 2)):
        avail = [i for i in range(n) if i not in lost]
        for want in (list(lost), list(lost) + avail[:1]):
            try:
                expect = ref.minimum_to_decode(want, avail)
            except ref_ec.ErasureCodeError:
                with pytest.raises(ec.ErasureCodeError):
                    port.minimum_to_decode(want, avail)
                continue
            assert port.minimum_to_decode(want, avail) == expect
        if plugin == "clay":
            continue
        if len(lost) == 1:
            assert port.repair_cost(lost[0], avail) == \
                ref.repair_cost(lost[0], avail)
        rows = port.fold_rows(list(lost), avail)
        assert rows == ref.fold_rows(list(lost), avail)
        if rows is not None:
            R = port._fold_matrix(tuple(lost), tuple(rows))
            assert np.array_equal(R, ref._fold_matrix(tuple(lost),
                                                      tuple(rows)))
            # the fold matrix reconstructs the lost rows from ``rows``
            rng = np.random.default_rng(len(rows))
            full = _full(ref, rng.integers(0, 256, (port.k, 64),
                                           dtype=np.uint8))
            got = port.decode_folded_device(
                list(lost), rows, np.stack([full[r] for r in rows]))
            got = port.host_sync(got)
            assert all(np.array_equal(got[j], full[i])
                       for j, i in enumerate(lost))


def test_locality_folds_are_narrow():
    """A single failure of an LRC group member folds over its group, and
    of a SHEC data chunk over its shingle window: fewer rows than k."""
    lrc = _port("lrc", {"k": "4", "m": "2", "l": "3"}, "torch")
    shec = _port("shec", {"k": "8", "m": "4", "c": "3"}, "torch")
    for codec in (lrc, shec):
        n = codec.chunk_count
        for lost in range(codec.k):
            rows = codec.fold_rows([lost],
                                   [i for i in range(n) if i != lost])
            assert rows is not None and len(rows) < codec.k, (lost, rows)
    assert lrc.fold_rows([0], [1, 2, 3, 4, 5, 6, 7]) == [1, 2, 6]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("plugin,prof", CLAY, ids=CLAY_IDS)
def test_clay_repair_equals_the_reference(plugin, prof, backend):
    """CLAY's sub-chunk repair of every chunk, its folded form over
    three objects and minimum_sub_chunks, against the reference; where
    d < n-1 (m != q) repair refuses and the full decode serves."""
    port, ref = _port(plugin, prof, backend), _ref(plugin, prof)
    n = port.chunk_count
    L = _chunk_len(port)
    rng = np.random.default_rng(port.alpha)
    fulls = [_full(ref, rng.integers(0, 256, (port.k, L), dtype=np.uint8))
             for _ in range(3)]
    if port.m != port.q:
        with pytest.raises(ec.ErasureCodeError, match="d = k\\+m-1"):
            port.repair_chunk(0, {}, L)
        got = port.decode([0], {i: c for i, c in fulls[0].items() if i})
        assert np.array_equal(got[0], fulls[0][0])
        return
    for lost in range(n):
        avail = [i for i in range(n) if i != lost]
        subs = port.minimum_sub_chunks(lost, avail)
        assert subs == ref.minimum_sub_chunks(lost, avail)
        assert all(len(p) == port.alpha // port.q for p in subs.values())
        planes = port.repair_planes(lost)
        helpers = [{h: f[h].reshape(port.alpha, -1)[planes] for h in avail}
                   for f in fulls]
        got = port.repair_chunk(lost, helpers[0], L)
        assert np.array_equal(got, ref.repair_chunk(lost, helpers[0], L))
        assert np.array_equal(got, fulls[0][lost])
        folded = port.repair_chunk_folded(lost, helpers, L)
        want = ref.repair_chunk_folded(lost, helpers, L)
        for i in range(3):
            assert np.array_equal(folded[i], want[i])
            assert np.array_equal(folded[i], fulls[i][lost])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("plugin,prof", CLAY, ids=CLAY_IDS)
def test_clay_folded_encode_and_decode_equal_the_reference(plugin, prof,
                                                          backend):
    """encode_chunks_folded over four objects (one all-zero slot, as the
    batcher's pow2 padding makes) and decode_chunks_folded of m erasures,
    against the reference's folded forms and the per-object codec."""
    port, ref = _port(plugin, prof, backend), _ref(plugin, prof)
    L = _chunk_len(port)
    rng = np.random.default_rng(port.k * port.m)
    data = rng.integers(0, 256, (4, port.k, L), dtype=np.uint8)
    data[3] = 0
    folded = np.ascontiguousarray(data.transpose(1, 0, 2)).reshape(
        port.k, 4 * L)
    parity = port.encode_chunks_folded(folded, 4, L)
    assert np.array_equal(parity, ref.encode_chunks_folded(folded, 4, L))
    assert not parity[:, 3 * L:].any()
    for i in range(3):
        assert np.array_equal(parity[:, i * L:(i + 1) * L],
                              ref.encode_chunks(data[i]))
    stack = np.concatenate([folded, parity])
    n = port.chunk_count
    erased = list(range(1, 1 + port.m))
    avail = [i for i in range(n) if i not in erased]
    out = port.decode_chunks_folded(erased, avail, stack[avail], 4, L)
    assert np.array_equal(out, ref.decode_chunks_folded(
        erased, avail, stack[avail], 4, L))
    assert np.array_equal(out, stack[erased])


@pytest.mark.parametrize("plugin,prof", PROFILES, ids=IDS)
def test_wide_plugins_default_to_torch_on_the_card(plugin, prof):
    """Deliberate difference: the wide plugins default to backend=torch
    on device=cuda (the JAX package's default, auto, resolves to
    native); an explicit auto resolves as the JAX package's does."""
    codec = ec.factory(plugin, dict(prof, device="cpu"))
    assert codec._backend == "torch"
    assert codec.device == torch.device("cpu")
    auto = ec.factory(plugin, dict(prof, backend="auto"))
    assert auto._backend == _ref(plugin, dict(prof, backend="auto")) \
        ._backend == "native"
    if not torch.cuda.is_available():
        with pytest.raises(ec.ErasureCodeError):
            ec.factory(plugin, dict(prof))


def test_lrc_inner_layer_codecs_run_on_numpy(monkeypatch):
    """Deliberate difference: LRC builds each layer's inner codec only
    to read its matrix, on the numpy backend, so an LRC code on the card
    allocates nothing for them (the JAX package's resolves to native);
    the matrix bytes are the same."""
    seen = []
    real = registry.factory

    def spy(name, profile=None):
        codec = real(name, profile)
        seen.append((name, codec._backend))
        return codec

    monkeypatch.setattr(registry, "factory", spy)
    codec = ec.factory("lrc", dict(LAYERS_PROFILE, device="cpu"))
    assert seen == [("jerasure", "numpy")]
    assert codec._backend == "torch"
    assert np.array_equal(codec.full, _ref("lrc", LAYERS_PROFILE).full)


def test_plugins_refuse_what_the_reference_refuses():
    for plugin, prof in [("clay", {"k": "4", "m": "2", "d": "4"}),
                         ("clay", {"k": "4", "m": "2", "d": "6"}),
                         ("lrc", {"k": "4", "m": "2", "l": "4"}),
                         ("lrc", {"mapping": "DD_", "layers": "nope"}),
                         ("shec", {"k": "4", "m": "2", "c": "3"}),
                         ("shec", {"technique": "other"})]:
        with pytest.raises(ref_ec.ErasureCodeError):
            _ref(plugin, prof)
        with pytest.raises(ec.ErasureCodeError):
            _port(plugin, prof, "torch")


def test_clay_subchunk_addresses_stay_int64_on_host_buffers(monkeypatch):
    """On the native backend every coupling call receives address arrays
    computed in int64 on numpy buffers (never float, never a tensor's
    data_ptr), and the bytes equal the torch backend's."""
    from ceph_tpu_torch.ops import native

    calls = []
    real = native.lincomb_rows_ptrs

    def spy(d, a, b, ca, cb, L):
        calls.append(tuple(np.asarray(x).dtype for x in (d, a)
                           + ((b,) if b is not None else ())))
        return real(d, a, b, ca, cb, L)

    monkeypatch.setattr(native, "lincomb_rows_ptrs", spy)
    prof = {"k": "4", "m": "2", "d": "5"}
    host, dev = _port("clay", prof, "native"), _port("clay", prof, "torch")
    data = np.random.default_rng(3).integers(0, 256, (4, host.alpha * 32),
                                             dtype=np.uint8)
    assert np.array_equal(host.encode_chunks(data), dev.encode_chunks(data))
    assert calls and all(t == np.dtype(np.int64)
                         for c in calls for t in c)
