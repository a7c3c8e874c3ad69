"""The port's ECBatcher on the wide codes against the JAX package's: the
sub-chunk encode and decode folds and the repair fold of CLAY, and the
narrow ``plain`` decode folds of LRC (one locality group) and SHEC (one
shingle window), each over several ops that coalesce into one flush.

Coalescing is forced, never timed: the window is far longer than any
run, the byte limit is exactly the burst's bytes, so the last op to
arrive flushes the whole group at once; the submitting threads are
daemons released by a barrier with a timeout.  The tests assert bytes
(tolerance 0) and fold counts only.  The port runs on the ``torch``
backend on the CPU (the kernels' plain versions) and on ``native``; the
JAX package's batcher on its ``native`` backend."""

import threading

import numpy as np
import pytest
import torch

from ceph_tpu import ec as ref_ec
from ceph_tpu.ec.batcher import ECBatcher as RefBatcher
from ceph_tpu_torch import ec
from ceph_tpu_torch.ec.batcher import ECBatcher, bucket_len
from ceph_tpu_torch.ops import native

# small CPU tensors: one thread, so the suite's parallel workers do not
# oversubscribe the cores
torch.set_num_threads(1)

#: a window no run reaches: groups flush on their byte limit
WINDOW_US = 30_000_000
BACKENDS = ["torch", "native"]
CLAYS = [{"k": "4", "m": "2", "d": "5"}, {"k": "5", "m": "3", "d": "7"}]
CLAY_IDS = ["clay-4-2-5", "clay-5-3-7"]


def _port(plugin, prof, backend):
    extra = {"device": "cpu"} if backend == "torch" else {}
    return ec.factory(plugin, dict(prof, backend=backend, **extra))


def _ref(plugin, prof):
    return ref_ec.factory(plugin, dict(prof, backend="native"))


def _burst(fn, n):
    """fn(i) for i < n from n daemon threads released together; returns
    the results in order, raising the first error."""
    res, errs = [None] * n, []
    gate = threading.Barrier(n, timeout=60)

    def run(i):
        try:
            gate.wait()
            res[i] = fn(i)
        except BaseException as e:  # noqa: BLE001 - raised below
            errs.append(e)

    threads = [threading.Thread(target=run, args=(i,), daemon=True)
               for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads), "a thread hung"
    if errs:
        raise errs[0]
    return res


def _pair(nbytes):
    """A port and a JAX batcher that flush a group at ``nbytes``."""
    return (ECBatcher(window_us=WINDOW_US, max_bytes=nbytes),
            RefBatcher(window_us=WINDOW_US, max_bytes=nbytes))


def _stripes(codec, n, L, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (codec.k, L), dtype=np.uint8)
            for _ in range(n)]


def _full(codec, data):
    parity = codec.encode_chunks(data)
    out = {i: data[i] for i in range(codec.k)}
    out.update({codec.k + j: parity[j] for j in range(codec.m)})
    return out


@pytest.mark.parametrize("with_csums", [False, True])
@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("prof", CLAYS, ids=CLAY_IDS)
def test_subchunk_encode_fold_matches_the_reference(prof, backend,
                                                    with_csums):
    """Five CLAY encodes fold into one sub-chunk flush (three zero
    stripe slots of padding) in both batchers: parity and csums equal,
    the csums equal native crc32c."""
    codec, ref = _port("clay", prof, backend), _ref("clay", prof)
    L = codec.alpha * 48
    datas = _stripes(codec, 5, L, 1)
    mine, theirs = _pair(5 * codec.k * L)
    got = _burst(lambda i: mine.encode(codec, datas[i],
                                       with_csums=with_csums), 5)
    want = _burst(lambda i: theirs.encode(ref, datas[i],
                                          with_csums=with_csums), 5)
    for b in (mine, theirs):
        assert (b.stats["launches"], b.stats["ops"], b.stats["size"]) == \
            (1, 5, 1)
    for i in range(5):
        assert np.array_equal(got[i][0], want[i][0])
        assert np.array_equal(got[i][0], ref.encode_chunks(datas[i]))
        if with_csums:
            assert np.array_equal(got[i][1], want[i][1])
            stack = np.concatenate([datas[i], got[i][0]])
            assert got[i][1].tolist() == [native.crc32c(r) for r in stack]
        else:
            assert got[i][1] is None


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("prof", CLAYS, ids=CLAY_IDS)
def test_subchunk_decode_fold_matches_the_reference(prof, backend):
    """Three CLAY decodes of m erased chunks (a data and a parity chunk
    among them) fold into one sub-chunk flush in both batchers, with the
    same bytes."""
    codec, ref = _port("clay", prof, backend), _ref("clay", prof)
    L = codec.alpha * 40
    fulls = [_full(ref, d) for d in _stripes(codec, 3, L, 2)]
    erased = [1] + list(range(codec.k + 1, codec.chunk_count))
    assert len(erased) == codec.m

    def avail(i):
        return {s: c for s, c in fulls[i].items() if s not in erased}

    nbytes = 3 * (codec.chunk_count - codec.m) * L
    mine, theirs = _pair(nbytes)
    got = _burst(lambda i: mine.decode(codec, erased, avail(i)), 3)
    want = _burst(lambda i: theirs.decode(ref, erased, avail(i)), 3)
    for b in (mine, theirs):
        assert (b.stats["launches"], b.stats["ops"]) == (1, 3)
    for i in range(3):
        for s in erased:
            assert np.array_equal(got[i][s], want[i][s])
            assert np.array_equal(got[i][s], fulls[i][s])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("prof", CLAYS, ids=CLAY_IDS)
def test_repair_fold_matches_the_reference(prof, backend):
    """Four repairs of one lost chunk from the same helpers fold into one
    repair flush in both batchers; each equals the stored chunk and the
    JAX codec's repair_chunk."""
    codec, ref = _port("clay", prof, backend), _ref("clay", prof)
    L = codec.alpha * 32
    lost = 2
    planes = codec.repair_planes(lost)
    fulls = [_full(ref, d) for d in _stripes(codec, 4, L, 3)]

    def subs(i):
        return {h: fulls[i][h].reshape(codec.alpha, -1)[planes]
                for h in range(codec.chunk_count) if h != lost}

    nbytes = 4 * sum(s.nbytes for s in subs(0).values())
    mine, theirs = _pair(nbytes)
    got = _burst(lambda i: mine.repair(codec, lost, subs(i), L), 4)
    want = _burst(lambda i: theirs.repair(ref, lost, subs(i), L), 4)
    for b in (mine, theirs):
        assert (b.stats["launches"], b.stats["ops"]) == (1, 4)
    for i in range(4):
        assert np.array_equal(got[i], want[i])
        assert np.array_equal(got[i], fulls[i][lost])
        assert np.array_equal(got[i], ref.repair_chunk(lost, subs(i), L))


NARROW = [("lrc", {"k": "4", "m": "2", "l": "3"}, 1),
          ("shec", {"k": "8", "m": "4", "c": "3"}, 3)]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("plugin,prof,lost", NARROW, ids=["lrc", "shec"])
def test_narrow_plain_folds_match_the_reference(plugin, prof, lost,
                                                backend, monkeypatch):
    """Four decodes of one lost data chunk fold into one plain flush that
    reads only the repair equation's rows (fewer than k) in the port,
    with the JAX batcher's bytes."""
    codec, ref = _port(plugin, prof, backend), _ref(plugin, prof)
    L = 3000
    fulls = [_full(ref, d) for d in _stripes(codec, 4, L, 4)]
    rows = codec.fold_rows([lost], [s for s in range(codec.chunk_count)
                                    if s != lost])
    assert rows == ref.fold_rows([lost], [s for s in
                                          range(codec.chunk_count)
                                          if s != lost])
    assert len(rows) < codec.k
    read = []
    real = type(codec).decode_folded_device

    def spy(self, want, avail, stacked):
        read.append((list(avail), tuple(stacked.shape)))
        return real(self, want, avail, stacked)

    monkeypatch.setattr(type(codec), "decode_folded_device", spy)

    def avail(i):
        return {s: c for s, c in fulls[i].items() if s != lost}

    nbytes = 4 * (codec.chunk_count - 1) * L
    mine, theirs = _pair(nbytes)
    got = _burst(lambda i: mine.decode(codec, [lost], avail(i)), 4)
    want = _burst(lambda i: theirs.decode(ref, [lost], avail(i)), 4)
    for b in (mine, theirs):
        assert (b.stats["launches"], b.stats["ops"]) == (1, 4)
    if backend == "torch":
        # the plain fold stacks the narrow rows only: (|rows|, 4 x bucket)
        assert read == [(rows, (len(rows), 4 * bucket_len(L)))]
    for i in range(4):
        assert np.array_equal(got[i][lost], want[i][lost])
        assert np.array_equal(got[i][lost], fulls[i][lost])


@pytest.mark.parametrize("backend", BACKENDS)
def test_shec_multi_erasure_folds_and_refusals(backend):
    """A decodable 3-erasure SHEC set folds (k rows); a set the code
    cannot decode passes through and raises the codec's own error, in
    the port as in the JAX batcher."""
    prof = {"k": "8", "m": "4", "c": "3"}
    codec, ref = _port("shec", prof, backend), _ref("shec", prof)
    L = 2048
    fulls = [_full(ref, d) for d in _stripes(codec, 2, L, 5)]
    erased = [0, 1, 2]
    nbytes = 2 * (codec.chunk_count - 3) * L
    mine, theirs = _pair(nbytes)
    got = _burst(lambda i: mine.decode(codec, erased, {
        s: c for s, c in fulls[i].items() if s not in erased}), 2)
    assert mine.stats["launches"] == 1
    for i in range(2):
        for s in erased:
            assert np.array_equal(got[i][s], fulls[i][s])
    bad = [0, 1, 2, 3, 4]
    for b, c in ((mine, codec), (theirs, ref)):
        with pytest.raises((ec.ErasureCodeError, ref_ec.ErasureCodeError)):
            b.decode(c, bad, {s: x for s, x in fulls[0].items()
                              if s not in bad})


def test_subchunk_passes_through_misaligned_and_tensor_inputs():
    """An encode or decode whose length is not a whole number of
    sub-chunks, or an encode whose data is a tensor, takes the codec's
    own path (a pass-through): the codec's error, or its bytes; with
    batching off a repair is the codec's repair_chunk."""
    prof = {"k": "4", "m": "2", "d": "5"}
    codec, ref = _port("clay", prof, "torch"), _ref("clay", prof)
    b = ECBatcher(window_us=WINDOW_US, max_bytes=1 << 30)
    with pytest.raises(ec.ErasureCodeError):
        b.encode(codec, np.zeros((4, codec.alpha * 8 + 1), np.uint8))
    data = _stripes(codec, 1, codec.alpha * 8, 6)[0]
    parity, csums = b.encode(codec, torch.from_numpy(data))
    assert np.array_equal(parity, ref.encode_chunks(data)) and csums is None
    assert (b.stats["launches"], b.stats["idle"]) == (1, 1)
    full = _full(ref, data)
    with pytest.raises(ec.ErasureCodeError):
        b.decode(codec, [0], {s: full[s][:-1] for s in range(1, 6)})
    off = ECBatcher(window_us=0)
    planes = codec.repair_planes(0)
    subs = {h: full[h].reshape(codec.alpha, -1)[planes]
            for h in range(1, 6)}
    assert np.array_equal(off.repair(codec, 0, subs, data.shape[1]),
                          full[0])
    assert off.stats["idle"] == 1


def test_a_failing_subchunk_flush_fails_each_op():
    """More erasures than m in a sub-chunk fold: every op of the flush
    gets the codec's error, none hangs."""
    prof = {"k": "4", "m": "2", "d": "5"}
    codec = _port("clay", prof, "torch")
    L = codec.alpha * 8
    full = _full(codec, _stripes(codec, 1, L, 7)[0])
    erased = [0, 1, 2]
    b = ECBatcher(window_us=WINDOW_US, max_bytes=2 * 3 * L)

    def dec(i):
        try:
            b.decode(codec, erased, {s: full[s] for s in (3, 4, 5)})
        except ec.ErasureCodeError as e:
            return e
        return None

    errs = _burst(dec, 2)
    assert all(isinstance(e, ec.ErasureCodeError) for e in errs)
    assert (b.stats["launches"], b.stats["ops"]) == (1, 2)


def test_repair_flush_tag_matches_the_reference():
    sig = ("rep", ("clay", 4, 2, 5), 2, (0, 1, 3, 4, 5), 2048)
    assert ECBatcher._sig_tag(sig) == RefBatcher._sig_tag(sig) == \
        "rep/clay/lost2/L2048"
